"""One card test of kernel B4's wgmma route, run as a child process.

``tests/test_torch_cuda.py`` starts this script with a JSON case and a time
limit, so that a kernel that hangs (a barrier whose phase never completes)
fails that one test instead of the whole run. It prints one line per call
and exits 1 if any call is out of its limit of the plain version, not
bit-reproducible, or differs between 64-row and 128-row items; the views
case also holds each view bit-equal to its contiguous copy, and the names
case that the profiler names ``flash_fwd_wgmma``, another instance of it
for 128-row items than for 64-row ones.

    python tests/_torch_wgmma_child.py '{"kind": "edges", "dtype": "bfloat16", "hd": 64}'
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_plain  # noqa: E402

# S = T on each side of the 64- and 128-row items and the 128-key tiles,
# and the serve prompt
EDGES = (1, 63, 64, 65, 127, 128, 129, 1000)
# (S, T): S != T, causal (query i sees keys j <= i) and not
UNEVEN = ((64, 129), (129, 64), (100, 300), (300, 100))
# (H, KV): GQA groups of 1, 6 and 8
GROUPS = ((2, 2), (6, 1), (8, 1))


def limit(want, q, k, v, causal):
    """The smoke's limit at the lowest precision among q, k and v: two
    units of roundoff of |want| + Σ_j p_ij |v_j|, at most 3e-2."""
    rel = 2.0**-7 if torch.bfloat16 in {q.dtype, k.dtype, v.dtype} else 2.0**-10
    scale = want.float().abs() + flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                                       causal=causal)
    return (rel * scale).clamp(max=3e-2)


def inputs(b, s, t, h, kv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)
                 for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def widened(q, k, v):
    """q, k and v with the batch repeated until the launch's (128-row
    q-tile, head, batch) items fill the card, where it takes 128-row items
    (two consumer warpgroups) instead of 64-row ones; and the repeats."""
    b, s, h, _ = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    items = -(-s // 128) * h * b
    assert items < sms, f"{tuple(q.shape)} already fills the card in 128-row items"
    reps = -(-sms // items)
    return tuple(a.repeat(reps, 1, 1, 1) for a in (q, k, v)), reps


def one(label, q, k, v, causal=True) -> bool:
    """A call against the plain version, again bit for bit, and bit for bit
    in each repeat of a call that takes 128-row items (every case here
    takes 64-row ones alone)."""
    got = ops.flash_attention_padded(q, k, v, causal=causal)
    again = ops.flash_attention_padded(q, k, v, causal=causal)
    wide, reps = widened(q, k, v)
    rows128 = ops.flash_attention_padded(*wide, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    within = bool(((got.float() - want.float()).abs() <= limit(want, q, k, v, causal)).all())
    same = torch.equal(got, again)
    items = torch.equal(rows128, got.repeat(reps, 1, 1, 1))
    err = float((got.float() - want.float()).abs().max())
    print(f"{label}: max abs error {err:.3e} within the limit {within}, reproducible {same}, "
          f"64-row and 128-row items bit-equal {items}", flush=True)
    return within and same and items


def edges(dtype, hd) -> bool:
    ok = True
    for s in EDGES:
        ok &= one(f"{dtype} hd {hd} S = T = {s}", *inputs(2, s, s, 2, 2, hd, dtype, s))
    for s, t in UNEVEN:
        for causal in (True, False):
            ok &= one(f"{dtype} hd {hd} S {s} T {t} causal {causal}",
                      *inputs(1, s, t, 4, 2, hd, dtype, s + t), causal=causal)
    for h, kv in GROUPS:
        for s in (129, 1000):
            ok &= one(f"{dtype} hd {hd} (H, KV) = ({h}, {kv}) S = T = {s}",
                      *inputs(1, s, s, h, kv, hd, dtype, h + s))
    return ok


def views(dtype) -> bool:
    """Operands TMA cannot read, copied by cp.async into the same tiles:
    bit-equal to their contiguous copies, which TMA reads."""
    ok = True
    gen = torch.Generator().manual_seed(0)
    s = 200
    flat = torch.randn(3 * s * 68, generator=gen).to("cuda", dtype)
    seq68 = [flat[i * s * 68:(i + 1) * s * 68].view(1, s, 68)[..., :64].unflatten(-1, (1, 64))
             for i in range(3)]
    flat = torch.randn(1 + 130 * 6 * 128, generator=gen).to("cuda", dtype)
    base = [flat[1:].view(1, 130, 6, 128)] + [torch.randn((1, 130, 2, 128), generator=gen)
                                              .to("cuda", dtype) for _ in range(2)]
    flat = torch.randn(130 * 4 * 100, generator=gen).to("cuda", dtype)
    hd96 = [flat.view(1, 130, 4, 100)[..., :96]] * 3  # heads 200 bytes apart
    for what, (q, k, v) in {"a sequence stride of 68 at hd 64": seq68,
                            "a base 2 bytes past 16-byte alignment at hd 128": base,
                            "a head stride of 100 at hd 96": hd96}.items():
        for causal in (True, False):
            got = ops.flash_attention_padded(q, k, v, causal=causal)
            copy = ops.flash_attention_padded(q.contiguous(), k.contiguous(), v.contiguous(),
                                              causal=causal)
            same = torch.equal(got, copy)
            print(f"{dtype} view with {what}, causal {causal}: bit-equal to its contiguous copy "
                  f"{same}", flush=True)
            ok &= same and one(f"{dtype} view with {what}", q, k, v, causal=causal)
    return ok


def ran(q, k, v) -> set:
    """The flash kernels the profiler names for calls on q, k and v."""
    from torch.profiler import ProfilerActivity, profile

    ops.flash_attention_padded(q, k, v)
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):  # the profiler may keep no device event of a short window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ops.flash_attention_padded(q, k, v)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events() if "flash_fwd" in e.name}
        if names:
            break
    return names


def names() -> bool:
    """bf16 and f16 at hd 33, 64 and 128 launch flash_fwd_wgmma, one
    instance for 64-row items and another for 128-row ones."""
    ok = True
    for dtype in (torch.bfloat16, torch.float16):
        for hd in (33, 64, 128):
            q, k, v = inputs(2, 130, 130, 4, 2, hd, dtype, hd)
            rows64, rows128 = ran(q, k, v), ran(*widened(q, k, v)[0])
            good = all(len(r) == 1 and "flash_fwd_wgmma" in next(iter(r))
                       for r in (rows64, rows128)) and rows64 != rows128
            print(f"{dtype} hd {hd} ran {sorted(rows64)} in 64-row items and {sorted(rows128)} in "
                  f"128-row items", flush=True)
            ok &= good
    return ok


def main() -> int:
    case = json.loads(sys.argv[1])
    dtype = getattr(torch, case.get("dtype", "bfloat16"))
    if case["kind"] == "edges":
        ok = edges(dtype, case["hd"])
    elif case["kind"] == "views":
        ok = views(dtype)
    else:
        ok = names()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
