"""The megakernel's opponent variant (plain PyTorch twin) against JAX.

``agent_scan.opponent_slab_scalars`` is held against the JAX function in
float64 (packs within 1e-12, blocked windows exactly equal).  The twin of
``scan_kernels.mega_edge_ttc(opp=...)`` is held against JAX's
``pallas_scan.mega_edge_ttc(..., opp=...)`` in interpret mode on the
operands of tests/test_torch_mega.py plus opponent packs from cars placed
within 2.5 m of each other (as tests/test_scan_fast.py places them), at the
float32 bar: p99 |diff| < 1e-3 m, < 0.2 % of beams off by more than 4
texture cells, iTTC hits exactly equal, and some beam shortened.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.ops import agent_scan as jas, collision as jcol, pallas_scan
from red_gym_tpu.ops import scan as jscan
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.interop import to_tensor
from red_gym_tpu_torch.ops import agent_scan as tas, collision as tcol
from red_gym_tpu_torch.ops import scan as tscan, scan_kernels
from tests.test_torch_mega import A, B, E, T, TTC, _torch_args, operands  # noqa: F401

LENGTH, WIDTH = 0.58, 0.31


def _close_poses(rng, e_n, a_n):
    """Car 0 anywhere in a 4 m square, the others within 2.5 m of it."""
    base = rng.uniform(-2.0, 2.0, (e_n, 1, 2))
    near = base + rng.uniform(-2.5, 2.5, (e_n, a_n - 1, 2))
    xy = np.concatenate([base, near], axis=1)
    return np.concatenate([xy, rng.uniform(0, 2 * np.pi, (e_n, a_n, 1))], -1)


@pytest.mark.parametrize("num_agents", [2, 3])
def test_opponent_slab_scalars_match_jax(num_agents):
    kw = dict(num_beams=B, dtype="float64")
    jt = jscan.build_tables(JSimConfig(**kw), WIDTH, LENGTH)
    tt = tscan.build_tables(TSimConfig(**kw), WIDTH, LENGTH)
    poses = _close_poses(np.random.default_rng(num_agents), 256, num_agents)

    def one(p):
        return jas.opponent_slab_scalars(p, jcol.get_vertices(p, LENGTH, WIDTH), jt)

    j = np.asarray(jax.vmap(one)(jnp.asarray(poses)))
    tp = torch.from_numpy(poses)
    t = tas.opponent_slab_scalars(tp, tcol.get_vertices(tp, LENGTH, WIDTH), tt).numpy()
    assert t.shape == (256, num_agents, 10 * (num_agents - 1)) == j.shape
    for o in range(num_agents - 1):
        np.testing.assert_array_equal(t[..., 10 * o:10 * o + 2],
                                      j[..., 10 * o:10 * o + 2])
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)
    lo, hi = t[..., 0], t[..., 1]
    assert (hi > lo).any() and (hi - lo < B - 1).any(), "windows degenerate"


@pytest.fixture(scope="module")
def opp_packs():
    """(K, 10) float32 packs of 160 envs x 2 cars within 2.5 m, by JAX."""
    cfg = JSimConfig(num_agents=A, num_beams=B, dtype="float32")
    tables = jscan.build_tables(cfg, WIDTH, LENGTH, dtype=jnp.float32)
    poses = jnp.asarray(_close_poses(np.random.default_rng(15), E, A), jnp.float32)

    def one(p):
        return jas.opponent_slab_scalars(p, jcol.get_vertices(p, LENGTH, WIDTH),
                                         tables)

    opp = np.asarray(jax.vmap(one)(poses)).reshape(E * A, 10)
    return opp, np.asarray(tables.beam_sines)


def test_opp_reference_matches_jax_kernel(operands, opp_packs):  # noqa: F811
    rt, per_row, consts, cell = operands
    opp, sines = opp_packs
    p = {k: jnp.asarray(v) for k, v in per_row.items()}
    c = {k: jnp.asarray(v) for k, v in consts.items()}
    j_out, j_hit = pallas_scan.mega_edge_ttc(
        jnp.asarray(rt)[p["rows"]], p["dx"], p["dy"], p["f_s"], p["i_f"],
        p["inb"], p["vel"], c["fmat"], c["fmat_sw"], c["shift1"], c["gmat"],
        c["c_frac"], c["noise"], c["cosines"], c["side_dist"], 30.0, TTC, A, T,
        ew_dtype=jnp.float32, sines=jnp.asarray(sines), opp=jnp.asarray(opp))
    j_out, j_hit = np.asarray(j_out), np.asarray(j_hit)

    args = _torch_args(rt, per_row, consts, "float32")
    t_out, t_hit = scan_kernels.mega_edge_ttc_reference(
        **args, sines=to_tensor(sines), opp=to_tensor(opp))
    plain, plain_hit = scan_kernels.mega_edge_ttc_reference(**args)
    err = np.abs(t_out.numpy() - j_out)
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)
    np.testing.assert_array_equal(t_hit.numpy(), j_hit)
    # the hits are the pre-opponent scan's; some beams were shortened
    assert torch.equal(t_hit, plain_hit)
    assert (t_out < plain - 1e-6).any(), "fixture guard: no beam shortened"
    assert (t_out <= plain).all()


def test_opp_dispatcher_on_cpu_counts_nothing(operands, opp_packs):  # noqa: F811
    rt, per_row, consts, _ = operands
    opp, sines = opp_packs
    args = dict(_torch_args(rt, per_row, consts, "float32"),
                sines=to_tensor(sines), opp=to_tensor(opp))
    out, hit = scan_kernels.mega_edge_ttc(**args)
    ref, ref_hit = scan_kernels.mega_edge_ttc_reference(**args)
    assert torch.equal(out, ref) and torch.equal(hit, ref_hit)
    assert not any(scan_kernels.mega_edge_ttc.launches.values())
    with pytest.raises(ValueError, match="sines"):
        scan_kernels.mega_edge_ttc(**{**args, "sines": None})
    with pytest.raises(ValueError, match=r"opp must be \(K, 10"):
        scan_kernels.mega_edge_ttc(**{**args, "opp": args["opp"][:, :7]})
