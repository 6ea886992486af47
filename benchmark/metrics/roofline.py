"""The least time the card could take for a kernel, counted from the
shapes: frozen copies of ``chip_smoke.py``'s ``bound``, ``tap_work``,
``mega_bound`` and ``blend_bound`` and of its published H100 peaks, so
that a later change to the program's own tools moves no benchmark number.

Operands are given as tensors on the ``meta`` device (shape and dtype, no
data): ``operand(shape, dtype)``.
"""

from __future__ import annotations

import torch

# published H100 SXM peaks, the card's fastest rate for each type: float32
# FMAs outside the tensor cores (TF32 is another type), bf16 and float64 on
# the tensor cores, and the HBM3 rate
F32_FLOPS, BF16_FLOPS, F64_FLOPS, HBM_BYTES_PER_S = 67e12, 989e12, 67e12, 3.35e12
LANE_OPS_PER_S = F32_FLOPS / 2


def operand(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, f32: float = 0.0, bf16: float = 0.0, f64: float = 0.0,
          lane: float = 0.0) -> dict:
    """The larger of the operations (each type over the card's peak rate for
    it, summed) and the bytes (each input read once, each output written
    once) over the memory rate -> {"bound_ms", "bound_by"}."""
    ops_ms = 1e3 * (f32 / F32_FLOPS + bf16 / BF16_FLOPS + f64 / F64_FLOPS
                    + lane / LANE_OPS_PER_S)
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def tap_work(k_n: int, t_bins: int, b_n: int, ew_dtype) -> dict:
    """Operations of the seven (T x B) tap products of K rows, by type: the
    three range taps in float32, the four e/w taps bf16 x bf16 -> float32
    under a bf16 ew_dtype."""
    tap = 2.0 * k_n * t_bins * b_n
    if ew_dtype == torch.bfloat16:
        return {"f32": 3 * tap, "bf16": 4 * tap}
    return {"f32": 7 * tap}


def mega_bound(ops, out, hit) -> dict:
    """The megakernel's bound: per row seven (T x B) tap products
    (tap_work) and the packed rfft of three rows (T x T each, float64);
    its bytes are the K gathered texture rows, the per-row and constant
    operands, the noise slab or pool, and the scan and hits written
    once."""
    k_n, t_bins, b_n = ops["rows"].shape[0], ops["t_bins"], ops["c_frac"].shape[0]
    rt = ops["rt"]
    moved = k_n * rt.shape[1] * rt.element_size() + nbytes(
        ops["rows"], ops["scal"], ops["noise"], ops["fmat"], ops["gmat"], ops["c_frac"],
        ops["cosines"], ops["side_dist"], ops.get("sines"), ops.get("opp"),
        ops.get("pool_off"), out, hit)
    return bound(moved, f64=2.0 * k_n * 3 * t_bins * t_bins,
                 **tap_work(k_n, t_bins, b_n, ops["ew_dtype"]))


def blend_bound(kw, out, hit) -> dict:
    """An epilogue kernel's bound: seven (T x B) tap products per row for
    the edge forms, three for kernel 7; bytes of every operand it reads
    and of the scan (and hits) it writes."""
    k_n, t_bins = kw["spec_r"].shape
    b_n = kw["c_frac"].shape[0]
    specs = [kw[s] for s in ("spec_r", "spec_e", "spec_w") if s in kw]
    moved = nbytes(*specs, *(kw.get(n) for n in (
        "f_s", "wsum", "vel", "gmat", "c_frac", "noise", "cosines", "sines",
        "side_dist", "opp")), out, hit)
    if len(specs) == 3:
        return bound(moved, **tap_work(k_n, t_bins, b_n, kw["ew_dtype"]))
    return bound(moved, f32=2.0 * k_n * 3 * t_bins * b_n)


def megakernel_ms(envs: int, agents: int, beams: int, t_bins: int) -> float:
    """``mega_bound`` of the default path's call (bf16 texture rows of five
    channels and bf16 noise rows, the opponent cast, float32 constants)."""
    k_n = envs * agents
    ops = {"rows": operand((k_n,), torch.int32), "t_bins": t_bins,
           "rt": operand((1, 5 * t_bins), torch.bfloat16), "scal": operand((k_n, 8)),
           "noise": operand((envs, beams), torch.bfloat16),
           "fmat": operand((t_bins, t_bins)), "gmat": operand((t_bins, 3 * beams)),
           "c_frac": operand((beams,)), "cosines": operand((beams,)),
           "side_dist": operand((beams,)), "sines": operand((beams,)),
           "opp": operand((k_n, 10 * (agents - 1))), "ew_dtype": torch.bfloat16}
    return mega_bound(ops, operand((k_n, beams)), operand((k_n,)))["bound_ms"]


def kernel4_ms(envs: int, agents: int, beams: int, t_bins: int) -> float:
    """``blend_bound`` of kernel 4's call (the edge render with noise, iTTC
    and the opponent cast; bf16 e/w taps and noise rows)."""
    k_n = envs * agents
    kw = {"spec_r": operand((k_n, t_bins)), "spec_e": operand((k_n, t_bins)),
          "spec_w": operand((k_n, t_bins)), "f_s": operand((k_n,)),
          "wsum": operand((k_n,)), "vel": operand((k_n,)),
          "gmat": operand((t_bins, 3 * beams)), "c_frac": operand((beams,)),
          "noise": operand((envs, beams), torch.bfloat16), "cosines": operand((beams,)),
          "sines": operand((beams,)), "side_dist": operand((beams,)),
          "opp": operand((k_n, 10 * (agents - 1))), "ew_dtype": torch.bfloat16}
    return blend_bound(kw, operand((k_n, beams)), operand((k_n,)))["bound_ms"]


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def launch_ms(trace, kernels: tuple, launches: int) -> float | None:
    """Median device time of a call of ``kernels`` (launched one after the
    other, one each a call) over the ``launches`` longest calls: the calls
    at the cell's full row count, where smaller calls (the restart of a few
    envs) come between them.  None where the trace holds none."""
    events = trace.ops(*kernels)
    n = len(kernels)
    calls = [sum((b - a) for _, a, b in events[i:i + n]) / 1e3
             for i in range(0, len(events) - n + 1, n)]
    calls = sorted(calls)[-launches:] if launches else []
    return median(calls) if calls else None
