"""Serving driver: prefill a batch of prompts, then greedy decode (KV
caches for attention stacks, the O(1) state for RWKV6, KV caches beside
the SSM state and conv carry for hymba's hybrid blocks).  The port of the
JAX package's ``launch/serve.py`` (its single-replica loop; the
``--production`` mesh is distributed work and is not ported).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \\
      --smoke --batch 4 --prompt-len 48 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_1_6b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch moonshot_v1_16b_a3b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral_12b \\
      --smoke --prompt-len 24 --device cpu

``--prompt-len`` counts every position of the prompt, as in the JAX
package: for pixtral_12b the ``frontend_len`` image patches (256; 8 in the
smoke config) and the text tokens behind them.  An encoder-only config
(hubert_xlarge) does not decode and is refused; its path is
``models.transformer.forward``.

Without ``--device`` it runs on the CUDA device and raises when there is
none.  On the card, the prefill goes through the hand-written kernels:
every attention layer (hymba's and pixtral's too) through the
flash-attention kernel (``kernels/csrc/flash_attention.cu``), every RWKV
layer through the RWKV6-recurrence kernel (``kernels/csrc/rwkv6_scan.cu``),
every MoE layer through the MoE-dispatch kernel
(``kernels/csrc/moe_dispatch.cu``).  hymba's SSM heads run the plain
``ssm_scan`` (prefill) and ``ssm_decode`` ops, which have no kernel in
either package, and pixtral's patch projection is a plain matrix product.
Decoding uses the plain attention, RWKV6 and SSM ops
(``decode_attention``, ``rwkv6_decode``, ``ssm_decode``), as in the JAX
package, and the MoE-dispatch kernel in every MoE layer of every step.
MoE layers route with the JAX package's defaults (``PRNGKey(0)``, 16
expert groups).  ``Generation.launches``
counts every kernel of the package, by name, in each phase.  Weights are
random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch.configs import base as cb
from repro_torch.core.scheduler import resolve_device
from repro_torch.data.pipeline import batch_for
from repro_torch.kernels import registry
from repro_torch.models import transformer as tfm


class Generation(NamedTuple):
    ids: torch.Tensor             # (B, gen) int32 greedy tokens
    prefill_logits: torch.Tensor  # (B, vocab) logits of the last prompt slot
    prefill_s: float              # wall seconds of prefill + first argmax
    decode_s: float               # wall seconds of the gen - 1 decode steps
    launches: dict                # {phase: {kernel name: launches}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(params, cfg: cb.ModelConfig, batch: dict, gen: int
             ) -> Generation:
    """Prefill ``batch`` (``tokens`` (B, S), and the ``patches`` of a vision
    config), then ``gen - 1`` greedy decode steps: ``gen`` new tokens per
    lane, the first from the prefill.  The caches hold every prompt
    position (patches included) and the ``gen`` new tokens."""
    device = batch["tokens"].device
    n0 = registry.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    logits, state = tfm.prefill(params, cfg, batch,
                                tfm.prompt_len(cfg, batch) + gen)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    n1 = registry.launch_counts()
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        step_logits, state = tfm.decode_step(params, cfg, state, tok)
        tok = torch.argmax(step_logits, -1).to(torch.int32)
        outs.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    n2 = registry.launch_counts()
    return Generation(ids=torch.stack(outs, dim=1), prefill_logits=logits,
                      prefill_s=prefill_s, decode_s=decode_s,
                      launches={"prefill": {k: n1[k] - n0[k] for k in n0},
                                "decode": {k: n2[k] - n1[k] for k in n0}})


def main(argv=None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = cb.smoke_config(args.arch) if args.smoke else cb.get(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: it does not decode")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = tfm.init_params(cfg, generator, device)
    batch = batch_for(cfg, 0, args.batch, args.prompt_len)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out = generate(params, cfg, batch, args.gen)
    toks = args.batch * (args.gen - 1)
    print(f"prefill {args.batch}x{args.prompt_len} in {out.prefill_s:.2f}s; "
          f"decode {toks} tokens in {out.decode_s:.2f}s "
          f"({toks / max(out.decode_s, 1e-9):.1f} tok/s) on {device}")
    print("generated ids (lane 0):", out.ids[0, :12].tolist(), "...")
    return out


if __name__ == "__main__":
    main()
