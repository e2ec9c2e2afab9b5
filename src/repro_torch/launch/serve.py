"""Batched serving driver: prefill a prompt batch, then greedy decode.

Port of ``src/repro/launch/serve.py``. Usage:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 1000 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --batch 4 --prompt-len 1000 --gen 16

Parameters are random, from seed 0; prompts are drawn from a
``torch.Generator`` seeded with ``--seed`` (not the reference's
``jax.random`` prompts). A model with a front end (whisper's audio,
qwen2-vl's vision) gets the reference's zero stubs
(``steps.frontend_stubs``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import frontend_stubs, make_prefill_step, make_serve_step
from repro_torch.models import model as mdl
from repro_torch.models.config import InputShape, ModelConfig


@torch.inference_mode()
def generate(
    cfg: ModelConfig,
    params: mdl.LM,
    prompts: torch.Tensor,  # (B, P) int
    gen: int,
    *,
    vision_embeds: Optional[torch.Tensor] = None,
    frames: Optional[torch.Tensor] = None,
    device="cuda",
    on_step: Optional[Callable[[str, int], None]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompts``, then ``gen - 1`` greedy decode steps.

    Returns (token ids (B, gen), logits (gen, B, V)): step 0's logits are
    the prefill's at the last prompt position, step t's the t-th decode
    step's. ``on_step(phase, t)``, if given, is called after each step is
    enqueued, with ``phase`` ``"prefill"`` or ``"decode"``. The steps are
    ``launch/steps.py``'s prefill and serve steps over a cache of P + gen;
    ``vision_embeds`` and ``frames`` (the front ends' outputs) go to the
    prefill.
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = resolve_device(device)
    prompts = prompts.to(dev)
    shape = InputShape("generate", prompts.shape[1] + gen, prompts.shape[0], "prefill")
    batch = {"tokens": prompts}
    if vision_embeds is not None:
        batch["vision_embeds"] = vision_embeds.to(dev)
    if frames is not None:
        batch["frames"] = frames.to(dev)
    logits, caches = make_prefill_step(cfg, shape)(params, batch)
    serve_step = make_serve_step(cfg, shape)
    steps = [logits]
    tok = logits.argmax(dim=-1, keepdim=True)
    out = [tok]
    if on_step is not None:
        on_step("prefill", 0)
    for t in range(1, gen):
        logits, caches = serve_step(params, {"token": tok, "caches": caches})
        tok = logits.argmax(dim=-1, keepdim=True)
        steps.append(logits)
        out.append(tok)
        if on_step is not None:
            on_step("decode", t)
    return torch.cat(out, dim=1), torch.stack(steps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1, help="seed of the random prompts")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = mdl.init_params(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    marks = []

    def on_step(phase, t):
        sync()
        marks.append(time.perf_counter())

    sync()
    t0 = time.perf_counter()
    tokens, _ = generate(cfg, params, prompts, args.gen, device=dev, on_step=on_step,
                         **frontend_stubs(cfg, args.batch, dev))
    print(f"prefill ({args.batch}x{args.prompt_len}) in {marks[0] - t0:.2f}s")
    dt = marks[-1] - marks[0]
    n = args.gen - 1
    print(f"decoded {n} x {args.batch} tokens in {dt:.2f}s "
          f"({n * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("generations (token ids):")
    for row in tokens[: min(4, args.batch)].tolist():
        print("  ", row)


if __name__ == "__main__":
    main()
