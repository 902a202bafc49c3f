"""Entry points of the model stack."""
