#!/usr/bin/env python3
"""Kernel B4 built from this source and from another, in turns on the card.

Compiles ``csrc/flash_attention.cu`` and another source with the same C
interface (``--other``, for example an earlier commit's
``src/repro_torch/csrc/flash_attention.cu`` unpacked under ``build/``) into
``build/flash_turns/``, both ``nvcc`` at once, and prints each one's build
seconds and ptxas register and spill lines. Then, at the model paths' bf16
shapes (``chip_smoke.py``'s FLASH_PATH, FLASH_MOE and FLASH_WHISPER, and
with ``--tolerance`` FLASH_TRAIN and FLASH_LONG too), it compares the two
outputs and times them in turns (other, this, SDPA, SDPA, this, other):
CUDA events over 20 calls as called, and with the queue filled ahead,
beside the call's bound.

The comparison is bit for bit by default: two sources whose products run
in the same order must agree exactly. With ``--tolerance`` the two may sum
in different orders (say, ``wgmma`` against ``mma.sync``): each side is
held to the plain version within the smoke's bf16 limit
(``chip_smoke.flash_excess``), and the largest difference between them is
printed.

With ``--model`` it also times what the kernel moves end to end, with each
library in turns: qwen2-1.5b's prefill at the serve batch and prompt (4 ×
1,000, bf16, 28 launches) and qwen3-0.6b's train step (4 × 1,024, bf16
over f32 parameters, remat on, 56 launches).

``--probe`` takes this source's wgmma route apart instead, with no other
source: it builds variants that leave parts out and times each with the
queue filled ahead, beside SDPA and the bound, at the five shapes of
``--tolerance``. All but ``whole`` compute wrong outputs and are only
timed; ``whole``'s output is held to the plain version's bf16 limit.

* ``whole``: the source as it is;
* ``no_softmax``: the loads and the products, the softmax's scale, mask,
  max, exp2 and sums left out (P is S as it comes);
* ``no_products``: the loads and the softmax, no wgmma issued;
* ``loads_only``: the ring, the barriers, the turns and P's stores.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.turns \\
        --other build/parent/src/repro_torch/csrc/flash_attention.cu [--tolerance] [--model]
    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.turns --probe
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]  # the repository
OUT = ROOT / "build" / "flash_turns"
ORDER = ("other", "this", "sdpa", "sdpa", "this", "other")
# --probe's variants: the parts of the wgmma route each leaves out, and the
# lines of the source it patches to do so (each must occur once)
PROBE = {"whole": (), "no_softmax": ("softmax",), "no_products": ("products",),
         "loads_only": ("softmax", "products")}
PROBE_SOFTMAX = "      softmax_tile<BK>(s, m, l, alpha, masked, k0, row0, Tk, causal, tig, scale_log2);"
PROBE_PRODUCTS = ("      Wgmma<T, BK>::ss(", "      Wgmma<T, HDP>::ss_bt(")


def _build_both(sources: dict) -> dict:
    """{label: loaded library}, compiling every source at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{label}.so"),
                                      str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
             for label, src in sources.items()}
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    libs = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[label]}:\n{log}")
        print(f"turns: {label} ({sources[label]}) built by {time.perf_counter() - t0:.3f} s")
        for fn, line in smoke.ptxas_report(log) + smoke.ptxas_serialized(log):
            print(f"  ptxas {label} {fn}: {line}")
        libs[label] = ctypes.CDLL(str(OUT / f"lib{label}.so"))
    return libs


def kernel_turns(torch, libs: dict, shapes, tolerance: bool) -> bool:
    """Each shape's comparison and times in turns; False where a check fails."""
    import torch.nn.functional as F

    import chip_smoke as smoke
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    gen = torch.Generator().manual_seed(0)
    name = torch.cuda.get_device_name(0)
    ok = True
    for shape in shapes:
        b, s, h, kv, hd = shape
        q, k, v = (torch.randn(dims, generator=gen).to("cuda", torch.bfloat16)
                   for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        outs = {label: ops.launch(lib, q, k, v, True) for label, lib in libs.items()}
        torch.cuda.synchronize()
        if tolerance:
            want = flash_attention_plain(q, k, v)
            excess = {label: smoke.flash_excess(out, want, q, k, v) for label, out in outs.items()}
            del want
            diff = float((outs["other"].float() - outs["this"].float()).abs().max())
            same = all(e <= 1.0 for e in excess.values())
            verdict = (f"each within the bf16 limit of the plain version: {same} (other "
                       f"{excess['other']:.3f}, this {excess['this']:.3f} of the limit); largest "
                       f"difference between them {diff:.3e}")
        else:
            same = torch.equal(outs["other"], outs["this"])
            verdict = f"outputs bit-equal {same}"
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        fns = {label: (lambda lib=lib: ops.launch(lib, q, k, v, True)) for label, lib in libs.items()}
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
        called = {label: [] for label in fns}
        queued = {label: [] for label in fns}
        for label in ORDER:
            called[label].append(smoke.time_ms(torch, fns[label], reps=20))
            queued[label].append(smoke.time_ms(torch, fns[label], reps=20, queued=True))
        bound, by, _, _ = smoke.flash_bound(name, q, k, v)
        order = ", ".join(ORDER)

        def series(d):
            it = {label: iter(vals) for label, vals in d.items()}
            return ", ".join(f"{next(it[label]):.6f}" for label in ORDER)

        print(f"turns: bf16 {shape} on {name}: {verdict}; ms a call in turns ({order}) as called "
              f"{series(called)}; queued {series(queued)}; bound {bound:.6f} ms ({by})")
        ok &= same
    return ok


def probe_source(src: str, parts) -> str:
    """The wgmma route's source with the named parts left out."""
    edits = []
    if "softmax" in parts:
        edits.append((PROBE_SOFTMAX, "      alpha[0] = alpha[1] = 1.f;"))
    if "products" in parts:
        edits += [(line, line.replace("Wgmma", "if (0) Wgmma")) for line in PROBE_PRODUCTS]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the source has {src.count(old)} copies of {old!r}, want 1")
        src = src.replace(old, new)
    return src


def probe(torch, libs: dict, shapes) -> bool:
    """Each variant's queued time beside SDPA's and the bound; False where
    the whole kernel is out of its limit."""
    import torch.nn.functional as F

    import chip_smoke as smoke
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    gen = torch.Generator().manual_seed(0)
    name = torch.cuda.get_device_name(0)
    ok = True
    for shape in shapes:
        b, s, h, kv, hd = shape
        q, k, v = (torch.randn(dims, generator=gen).to("cuda", torch.bfloat16)
                   for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        got = ops.launch(libs["whole"], q, k, v, True)
        excess = smoke.flash_excess(got, flash_attention_plain(q, k, v), q, k, v)
        ok &= excess <= 1.0
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        fns = {label: (lambda lib=lib: ops.launch(lib, q, k, v, True)) for label, lib in libs.items()}
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
        ms = {label: smoke.time_ms(torch, fn, reps=20, queued=True) for label, fn in fns.items()}
        bound, by, _, _ = smoke.flash_bound(name, q, k, v)
        print(f"probe: bf16 {shape} on {name}, ms a call with the queue filled ahead: "
              + ", ".join(f"{label} {t:.6f}" for label, t in ms.items())
              + f"; bound {bound:.6f} ({by}); whole within {excess:.3f} of its limit")
    return ok


def model_turns(torch, libs: dict, reps: int = 9) -> None:
    """qwen2-1.5b's prefill and qwen3-0.6b's train step with each library
    in turns: host ms per call after a synchronise, the median of ``reps``,
    and of one more call under torch.profiler the device-busy ms and the
    flash kernel's device ms (the host's share varies from call to call
    more than the kernel moves the step)."""
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw, linear_warmup_cosine

    def timed(fn) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def profiled(fn) -> tuple[float, float]:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = smoke._kernel_events(torch, prof)
        flash = sum(e.time_range.end - e.time_range.start for e in events if "flash_fwd" in e.name)
        return smoke._busy_us(events) / 1e3, flash / 1e3

    def in_turns(label, fn) -> None:
        turns = ("other", "this", "this", "other")
        host, busy, flash = [], [], []
        for name in turns:
            ops._lib = lambda lib=libs[name]: lib
            fn()  # warm-up with this library
            host.append(timed(fn))
            b, f = profiled(fn)
            busy.append(b)
            flash.append(f)

        def line(vals):
            return ", ".join(f"{x:.3f}" for x in vals)

        print(f"turns: {label}, in turns ({', '.join(turns)}): host ms (median of {reps}) "
              f"{line(host)}; device-busy ms {line(busy)}; flash kernel device ms {line(flash)}")

    saved = ops._lib
    try:
        cfg = get_config("qwen2-1.5b")
        params = mdl.init_params(cfg, 0, device="cuda")
        prompts = torch.randint(0, cfg.vocab_size, (4, 1000),
                                generator=torch.Generator(device="cuda").manual_seed(1),
                                device="cuda")

        def prefill():
            with torch.inference_mode():
                caches = mdl.init_cache(cfg, 4, 1002, device="cuda")
                mdl.forward(cfg, params, prompts, caches=caches)

        in_turns(f"{cfg.name} prefill (4, 1,000), {cfg.n_layers} flash launches", prefill)
        del params, prompts
        torch.cuda.empty_cache()
        cfg = get_config("qwen3-0.6b")
        state = steps.init_train_state(mdl.init_params(cfg, 0, device="cuda"),
                                       adamw(linear_warmup_cosine(3e-3, 2, 10)))
        step = steps.make_train_step(cfg, adamw(linear_warmup_cosine(3e-3, 2, 10)))
        bt = TokenPipeline(cfg.vocab_size, 4, 1024, seed=1).next_batch()
        batch = {key: torch.from_numpy(val).to("cuda", torch.int64)
                 for key, val in (("tokens", bt.tokens), ("targets", bt.targets))}
        in_turns(f"{cfg.name} train step (4 × 1,024), {2 * cfg.n_layers} flash launches",
                 lambda: step(state, batch))
    finally:
        ops._lib = saved


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="a flash_attention.cu with the same C interface")
    parser.add_argument("--tolerance", action="store_true",
                        help="hold each side to the plain version's limit instead of to each other")
    parser.add_argument("--model", action="store_true",
                        help="also time a prefill and a train step with each library in turns")
    parser.add_argument("--probe", action="store_true",
                        help="time this source's wgmma route with parts left out, no other source")
    args = parser.parse_args(argv)
    if (args.other is None) != args.probe:
        parser.error("give --other or --probe, not both")
    if not torch.cuda.is_available():
        print("flash turns: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    this = _build.CSRC / "flash_attention.cu"
    if args.probe:
        OUT.mkdir(parents=True, exist_ok=True)
        sources = {}
        for label, parts in PROBE.items():
            sources[label] = OUT / f"probe_{label}.cu"
            sources[label].write_text(probe_source(this.read_text(), parts))
    else:
        sources = {"other": Path(args.other).resolve(), "this": this}
    libs = _build_both(sources)
    for lib in libs.values():
        ops.bind(lib)
    import chip_smoke as smoke

    if args.probe:
        return 0 if probe(torch, libs, [smoke.FLASH_PATH, smoke.FLASH_MOE, smoke.FLASH_TRAIN,
                                        smoke.FLASH_WHISPER, smoke.FLASH_LONG]) else 1
    shapes = [smoke.FLASH_PATH, smoke.FLASH_MOE, smoke.FLASH_WHISPER]
    if args.tolerance:
        shapes += [smoke.FLASH_TRAIN, smoke.FLASH_LONG]
    ok = kernel_turns(torch, libs, shapes, args.tolerance)
    if args.model:
        model_turns(torch, libs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
