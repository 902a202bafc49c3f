"""The model stack: layers and the dense transformer."""
