"""The port's spans and counters (``red_gym_tpu_torch/utils/profiling.py``)
on the CPU: where a step records them under a torch.profiler session, how
they nest, that the restart counter counts the done envs, that nothing is
recorded with no session, that tracing changes no number, the set-up
spans of the params, and ``train_ppo --profile``'s report of them.  The
card test holds a step's synchronizing calls to the one it needs, the
host read of ``done`` inside ``rollout/done_read``."""

import copy
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from red_gym_tpu_torch import assets, env, rollout
from red_gym_tpu_torch.agents import ppo as tppo
from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.utils import profiling

E, A, B = 6, 2, 60
# envs whose two cars start on one pose: a body collision, so done at every
# step and restarted by every reset_done
OVERLAP = (0, 3)
STEPS = 4
CONFIGS = {
    # the library default: state kernel and scan megakernel with the opponent cast
    "megakernel": dict(),
    # train_ppo's bilinear scan: the prep chain, then kernel 4
    "bilinear": dict(rt_spatial="bilinear"),
    # the unfused tail: kernel 6, then the eager noise add, iTTC and opponent cast
    "unfused": dict(rt_spatial="bilinear", fuse_scan_ttc="off"),
}
STAGES = ("env/dynamics", "env/noise", "env/scan", "env/collision", "env/laps")


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    profiling.reset_totals()
    yield
    profiling.reset_totals()


def _cfg(name):
    return SimConfig(num_agents=A, num_beams=B, scan_mode="fast", rt_pose_stride=16,
                     **CONFIGS[name])


_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        _PARAMS[name] = env.make_params(_cfg(name), assets.named_map_yaml("track_0019"),
                                        device="cpu")
    return _PARAMS[name]


def _poses():
    table = torch.as_tensor(assets.start_pose_table(["track_0019"], A)[0],
                            dtype=torch.float32)
    poses = table.expand(E, A, 3).clone()
    for e in OVERLAP:
        poses[e, 1] = poses[e, 0]
    return poses


def _run(name, steps=STEPS, seed=7):
    """Reset, then ``steps`` closed-loop steps with random actions and
    restarts -> (state, obs, the done flags of every step)."""
    cfg, params = _cfg(name), _params(name)
    gen = torch.Generator().manual_seed(seed)
    state, obs, *_ = rollout.batched_reset(cfg, params, _poses(), gen)
    policy = rollout.random_policy(cfg)
    dones = []
    for _ in range(steps):
        state, obs, _, done, _ = env.step(cfg, params, state, policy(obs, gen), gen)
        dones.append(done)
        state, obs, _ = rollout.reset_done(cfg, params, state, obs, done, gen)
    return state, obs, dones


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _spans(prof):
    """[(name, enclosing span name or None)] of the recorded ranges."""
    events = [e for e in prof.events() if getattr(e, "is_user_annotation", False)]
    out = []
    for e in events:
        parent = e.cpu_parent
        while parent is not None and not getattr(parent, "is_user_annotation", False):
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_spans_nest_as_the_stages(name):
    _params(name)    # the set-up's spans before the session
    prof, _ = _profiled(lambda: _run(name))
    spans = _spans(prof)
    names = {n for n, _ in spans}
    parents = {}
    for n, p in spans:
        parents.setdefault(n, set()).add(p)
    # each stage once at the reset and once a step outside the restart, and
    # once a restart inside it
    for stage in STAGES:
        assert parents[stage] == {None, "rollout/restart"}, (stage, parents[stage])
        assert sum(n == stage for n, _ in spans) == 1 + 2 * STEPS
    assert parents["rollout/done_read"] == {None}
    assert parents["rollout/restart"] == {None}
    assert sum(n == "rollout/restart" for n, _ in spans) == STEPS
    fused_prep = name != "megakernel"
    assert ("scan/prep" in names) == fused_prep
    if fused_prep:
        assert parents["scan/prep"] == {"env/scan"}
    assert ("env/scan_tail" in names) == (name == "unfused")
    assert {n for n in names if not n.startswith(("env/", "scan/", "rollout/"))} == set()


def test_restarted_envs_counts_the_done_envs():
    assert profiling.counter_totals() == {}
    _, (_, _, dones) = _profiled(lambda: _run("megakernel"))
    total = int(sum(int(d.sum()) for d in dones))
    assert total >= len(OVERLAP) * STEPS
    assert profiling.counter_totals()["rollout/restarted_envs"] == total


def test_no_session_records_nothing(monkeypatch):
    made = []
    real = profiling._autograd_profiler.record_function

    def counted(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", counted)
    _run("unfused")
    assert made == [] and profiling.counter_totals() == {}
    # with a session the same code makes its ranges through that function
    _profiled(lambda: _run("unfused", steps=1))
    assert "env/scan_tail" in made and "rollout/restart" in made


def test_a_counter_refuses_a_device_number():
    with pytest.raises(TypeError):
        _profiled(lambda: profiling.count("x", torch.tensor(1)))


@pytest.mark.parametrize("name", ["megakernel", "unfused"])
def test_tracing_changes_no_number(name):
    plain = _run(name)
    _, traced = _profiled(lambda: _run(name))
    for a, b in zip(plain[:2], traced[:2]):
        for fa, fb in zip(a, b):
            assert (fa is None and fb is None) or torch.equal(fa, fb)
    assert all(torch.equal(a, b) for a, b in zip(plain[2], traced[2]))


def _train_step():
    """One PPO.train_step of a tiny bilinear trainer -> (loss, weights)."""
    cfg, params = _cfg("bilinear"), _params("bilinear")
    ppo = tppo.PPO(cfg, params, tppo.PPOConfig(rollout_len=4, minibatches=2, epochs=1),
                   tppo.ScanPolicy(B, 32, scan_stride=4))
    gen = torch.Generator().manual_seed(3)
    state, obs, *_ = rollout.batched_reset(cfg, params, _poses(), gen)
    pstate = ppo.init(torch.Generator().manual_seed(1))
    pstate, _, _, metrics = ppo.train_step(pstate, state, obs)
    return metrics["loss"], copy.deepcopy(pstate.policy.state_dict())


def test_tracing_changes_no_train_step():
    loss, weights = _train_step()
    prof, (t_loss, t_weights) = _profiled(_train_step)
    assert torch.equal(loss, t_loss)
    assert weights.keys() == t_weights.keys()
    assert all(torch.equal(weights[k], t_weights[k]) for k in weights)
    names = {n for n, _ in _spans(prof)}
    assert {"ppo/policy", "ppo/env_step", "ppo/reset", "ppo/update"} <= names
    assert ("rollout/restart", "ppo/reset") in set(_spans(prof))


def test_setup_spans_of_multimap_params():
    cfg = _cfg("bilinear")
    yamls = [assets.named_map_yaml(n) for n in ("track_0019", "track_0042")]
    prof, _ = _profiled(lambda: env.make_multimap_params(cfg, yamls, device="cpu"))
    # nested as the code nests them: params > map_load > edt, params > texture
    assert sorted(_spans(prof)) == sorted(
        [("setup/params", None)] + [("setup/map_load", "setup/params"),
                                    ("setup/edt", "setup/map_load"),
                                    ("setup/texture", "setup/params")] * 2)
    got = profiling.span_totals()
    assert {n: v["count"] for n, v in got.items()} == {
        "setup/params": 1, "setup/map_load": 2, "setup/edt": 2, "setup/texture": 2}
    sec = {n: v["seconds"] for n, v in got.items()}
    assert 0 < sec["setup/edt"] <= sec["setup/map_load"]
    assert sec["setup/map_load"] + sec["setup/texture"] <= sec["setup/params"]


def test_a_set_up_span_times_with_no_session(monkeypatch):
    made = []
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda name, *a, **k: made.append(name))
    for _ in range(2):
        with profiling.setup_span("setup/x"):
            pass
    got = profiling.span_totals()["setup/x"]
    assert got["count"] == 2 and got["seconds"] > 0 and made == []
    profiling.reset_totals()
    assert profiling.span_totals() == {} and profiling.counter_totals() == {}


def test_train_ppo_profile_reports_restarts_and_set_up(capsys):
    from red_gym_tpu_torch.examples import train_ppo

    train_ppo.main(["--device", "cpu", "--envs", "4", "--beams", "64", "--rollout", "4",
                    "--scan-mode", "exact", "--iters", "2", "--profile"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "envs restarted" in ln)
    assert "setup/params" in line and "setup/map_load" in line and "setup/edt" in line
    restarted = int(line.split("envs restarted in the iteration: ")[1].split(";")[0])
    assert restarted == profiling.counter_totals().get("rollout/restarted_envs", 0)


# The one synchronizing call a step needs: reset_done's host read of done.
# (The first warning after the mode is set is the mode's own notice that it
# is a prototype, not a synchronizing call.)
NOTICE = "Synchronization debug mode is a prototype feature"
DONE_READ = ("rollout/done_read", "idx = torch.nonzero(done).squeeze(1)")
# A known exception (PERF.md section 7, "A wait on the stream in sim_step"):
# sim_step copies the pose columns' index list to the card from pageable
# memory, which waits for the stream, in the step and in the restart's
# re-run.  Allowed here, not required, so that removing it passes.
POSE_INDEX = "poses = x[..., [0, 1, 4]]"


@pytest.mark.cuda
def test_a_step_syncs_only_at_the_done_read(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "--noconftest tests/test_torch_tracing.py -m cuda)")
    import traceback
    import warnings

    dev = torch.device("cuda", 0)
    cfg = _cfg("megakernel")
    params = env.make_params(cfg, assets.named_map_yaml("track_0019"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    state, obs, *_ = rollout.batched_reset(cfg, params, _poses().to(dev), gen)
    policy = rollout.random_policy(cfg)
    for _ in range(3):    # kernels built and loaded, packs cached
        state, obs, _, done, _ = env.step(cfg, params, state, policy(obs, gen), gen)
        state, obs, _ = rollout.reset_done(cfg, params, state, obs, done, gen)
    torch.cuda.synchronize()

    open_spans, syncs = [], []

    class watched(profiling.span):
        def __enter__(self):
            open_spans.append(self.name)
            return super().__enter__()

        def __exit__(self, *exc):
            open_spans.pop()
            return super().__exit__(*exc)

    def hook(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(NOTICE):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "red_gym_tpu_torch" in f.filename]
        syncs.append((open_spans[-1] if open_spans else None,
                      frames[-1].line if frames else str(message),
                      " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                 for f in stack[::-1][:6])))

    monkeypatch.setattr(env, "span", watched)
    monkeypatch.setattr(rollout, "span", watched)
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                actions = policy(obs, gen)
                state, obs, _, done, _ = env.step(cfg, params, state, actions, gen)
                seen.append(list(syncs))
                syncs.clear()
                state, obs, any_ = rollout.reset_done(cfg, params, state, obs, done, gen)
                seen.append(list(syncs))
                syncs.clear()
                assert any_
        finally:
            torch.cuda.set_sync_debug_mode(0)
    held = [[(sp, ln) for sp, ln, _ in calls if ln != POSE_INDEX] for calls in seen]
    assert held == [[], [DONE_READ]] * 3, seen
