"""The port's DLB-knob autotuner (``repro_torch.core.tune``) against the JAX
package's, on the CPU: whole search results on the graph and machine of
``tests/test_tune.py`` (closed system, an arrival process, a topology
preset), one committed ``experiments/tuned/smoke`` artifact reproduced in
full, the artifact files byte for byte, and the ladder refinement.

The committed smoke artifacts carry ``sim_signature`` aff2e05023893daa:
the cost model before ``CostModel.req_bytes`` existed.  The live physics
digest of the same ``SimConfig`` is 5abc437f58f79e03 in both packages, so
both refuse the committed files under ``load_tuned(..., cfg=...)``, and a
file written today also gains the ``objective`` field.  The live JAX
package is the reference; the committed files are read, never written.
"""

import dataclasses
import itertools
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core import tune as j_tune  # noqa: E402
from repro.core.scheduler import SimConfig as JSimConfig  # noqa: E402
from repro_torch import apps as t_apps  # noqa: E402
from repro_torch.core import taskgraph as t_tg  # noqa: E402
from repro_torch.core import tune as t_tune  # noqa: E402
from repro_torch.core.plan import CaseSpec  # noqa: E402
from repro_torch.core.spec import SLB_SPEC, RuntimeSpec, dlb_spec  # noqa: E402
from repro_torch.core.state import SimConfig  # noqa: E402
from repro_torch.core.sweep import run_cases  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TUNED = ROOT / "experiments" / "tuned"
ARTIFACTS = sorted((TUNED / "smoke").glob("*.json"))

#: the machine of tests/test_tune.py, and the smoke harness's
CFG = dict(n_workers=8, n_zones=2, max_steps=60_000)
SMOKE = dict(n_workers=16, n_zones=4, max_steps=60_000, stack_cap=64)
LIVE_SIG = "5abc437f58f79e03"
COMMITTED_SIG = "aff2e05023893daa"

#: small searches: (coarse grid, rounds, survivors, seeds, extra, kwargs)
SEARCHES = {
    "closed": (dict(n_victim=(1, 4), n_steal=(1, 8), t_interval=(10,),
                    p_local=(1.0,)), 2, 2, (0, 1), ((4, 8, 100, 1.0),), {}),
    "arrivals": (dict(n_victim=(1, 4), n_steal=(1, 8), t_interval=(10,),
                      p_local=(1.0,)), 1, 1, (0,), (),
                 dict(arrivals="poisson:2")),
    "topology": (dict(n_victim=(2,), n_steal=(4,), t_interval=(30,),
                      p_local=(0.5, 1.0)), 1, 1, (0,), (),
                 dict(topology="dual_socket_24")),
}


def plain(result: dict) -> dict:
    """A tune result with its TunedParams as a dict (the two packages'
    classes differ, their fields must not)."""
    return dict(result, params=result["params"].asdict())


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_tune_spec_returns_what_jax_returns(case):
    coarse, rounds, survivors, seeds, extra, kw = SEARCHES[case]
    spec = "na_ws" if case != "closed" else "na_rp"
    want = j_tune.tune_spec(
        j_tg.fib(8), spec, JSimConfig(**CFG), coarse=coarse, rounds=rounds,
        survivors=survivors, seeds=seeds,
        extra=[j_tune.TunedParams(*p) for p in extra], **kw)
    got = t_tune.tune_spec(
        t_tg.fib(8), spec, SimConfig(**CFG), coarse=coarse, rounds=rounds,
        survivors=survivors, seeds=seeds,
        extra=[t_tune.TunedParams(*p) for p in extra], device="cpu", **kw)
    assert plain(got) == plain(want)
    assert type(got["makespan_ns"]) is int and type(got["seeds"]) is tuple
    assert got["objective"] == ("makespan" if case != "arrivals"
                                else "p99_latency")
    if not extra:
        return
    # the pick can only match or beat the seeded reference, and its score
    # (the truncated mean over the seeds) reproduces through the engine
    knobs = [dict(zip(("n_victim", "n_steal", "t_interval", "p_local"),
                      extra[0])), got["params"].asdict()]
    res = run_cases(t_tg.fib(8), [CaseSpec(spec=spec, n_workers=8,
                                           n_zones=2, seed=sd, **k)
                                  for k in knobs for sd in seeds],
                    cfg=SimConfig(**CFG), device="cpu")
    ref_ns, pick_ns = (int(res.time_ns[i:i + len(seeds)].mean())
                       for i in (0, len(seeds)))
    assert got["makespan_ns"] == pick_ns <= ref_ns


def test_the_fib_na_ws_artifact_is_reproduced_in_full(tmp_path):
    """``fib__xqueue-tree-na_ws.json`` as ``benchmarks/tune_apps.py`` made
    it: the hand-tuned reference seeded, rounds 2, survivors 4; then the
    SLB and reference runs, and the file the port writes against the one
    the JAX package writes for the same results."""
    path = TUNED / "smoke" / "fib__xqueue-tree-na_ws.json"
    art = json.loads(path.read_text())
    g = t_apps.build("fib", scale="smoke")
    cfg = SimConfig(**SMOKE)
    spec = dlb_spec("na_ws")
    ref = t_tune.TunedParams(**art["ref"]["params"])
    got = t_tune.tune_spec(g, spec, cfg, extra=(ref,), rounds=2,
                           survivors=4, cache=None, device="cpu")
    assert got["params"].asdict() == art["params"] == dict(
        n_victim=1, n_steal=1, t_interval=10, p_local=1.0)
    for k in ("makespan_ns", "n_configs", "n_sims"):
        assert got[k] == art[k], k
    assert (got["makespan_ns"], got["n_configs"], got["n_sims"]) \
        == (8598, 56, 56)
    assert list(got["seeds"]) == art["seeds"]
    runs = run_cases(g, [CaseSpec(spec=SLB_SPEC, n_workers=16, n_zones=4),
                         CaseSpec(spec=spec, n_workers=16, n_zones=4,
                                  **art["ref"]["params"])],
                     cfg=cfg, device="cpu")
    slb_ns, ref_ns = (int(t) for t in runs.time_ns)
    assert (slb_ns, ref_ns) == (art["slb_ns"], art["ref"]["makespan_ns"])

    mine = t_tune.save_artifact(
        "fib", spec, got, cfg, smoke=True, slb_ns=slb_ns,
        ref=dict(params=art["ref"]["params"], makespan_ns=ref_ns),
        tuned_dir=str(tmp_path / "torch"))
    j_res = dict(got, params=j_tune.TunedParams(**art["params"]))
    theirs = j_tune.save_artifact(
        "fib", "na_ws", j_res, JSimConfig(**SMOKE), smoke=True,
        slb_ns=slb_ns,
        ref=dict(params=art["ref"]["params"], makespan_ns=ref_ns),
        tuned_dir=str(tmp_path / "jax"))
    written = pathlib.Path(mine).read_bytes()
    assert written == pathlib.Path(theirs).read_bytes()
    # the committed file, but for the two fields it predates
    live = dict(art, sim_signature=LIVE_SIG, objective="makespan")
    assert written == (json.dumps(live, indent=1, sort_keys=True)
                       + "\n").encode()


def test_sim_signature_matches_jax_and_dates_the_committed_artifacts():
    for kw in (SMOKE, CFG, {}, dict(SMOKE, queue_cap=8),
               dict(SMOKE, max_steps=200_000, n_workers=32)):
        assert t_tune.sim_signature(SimConfig(**kw)) \
            == j_tune.sim_signature(JSimConfig(**kw)), kw
    assert t_tune.sim_signature(SimConfig(**SMOKE)) == LIVE_SIG
    # the committed signature is today's smoke physics without req_bytes
    fields = dataclasses.asdict(SimConfig().costs)
    del fields["req_bytes"]
    old = dataclasses.make_dataclass(
        "OldCosts", [(k, type(v), v) for k, v in fields.items()])
    old_cfg = dataclasses.replace(SimConfig(**SMOKE), costs=old())
    assert t_tune.sim_signature(old_cfg) == COMMITTED_SIG
    assert {json.loads(p.read_text())["sim_signature"]
            for p in ARTIFACTS} == {COMMITTED_SIG}


def test_load_tuned_reads_every_committed_artifact_as_jax_does():
    assert len(ARTIFACTS) == 18
    d = str(TUNED)
    for p in ARTIFACTS:
        app, slug = p.stem.split("__")
        spec = RuntimeSpec.from_slug(slug)
        kw = dict(smoke=True, tuned_dir=d)
        scale = dict(n_workers=16, n_zones=4, max_steps=60_000)
        rec = t_tune.load_tuned(app, spec, **kw, **scale)
        assert rec == json.loads(p.read_text())
        assert rec == j_tune.load_tuned(app, slug, **kw, **scale)
        # both packages refuse it under the live physics digest
        assert t_tune.load_tuned(app, spec, cfg=SimConfig(**SMOKE),
                                 **kw) is None
        assert j_tune.load_tuned(app, slug, cfg=JSimConfig(**SMOKE),
                                 **kw) is None
        # another scale, spec, machine or offered load
        other = dlb_spec("na_rp" if spec.balance == "na_ws" else "na_ws")
        for bad in (dict(smoke=False, tuned_dir=d),
                    dict(kw, n_workers=32), dict(kw, n_zones=8),
                    dict(kw, max_steps=200_000),
                    dict(kw, topology="dual_socket_24"),
                    dict(kw, arrivals="poisson:2")):
            assert t_tune.load_tuned(app, spec, **bad) is None, bad
        assert t_tune.load_tuned(app, other, **kw) == \
            json.loads((p.parent / f"{app}__{other.slug}.json").read_text())
        assert t_tune.load_tuned(
            app, RuntimeSpec("xqueue", "centralized_count", spec.balance),
            **kw) is None


def test_load_tuned_refuses_other_code_versions_and_signatures(tmp_path):
    res = dict(params=t_tune.TunedParams(1, 2, 30, 0.5), makespan_ns=1234,
               n_configs=10, n_sims=12, seeds=(0,))
    cfg = SimConfig(**SMOKE)
    kw = dict(smoke=True, tuned_dir=str(tmp_path))
    path = t_tune.save_artifact("fib", "na_ws", res, cfg, **kw)
    assert t_tune.load_tuned("fib", "na_ws", cfg=cfg, **kw)["params"] \
        == res["params"].asdict()
    assert t_tune.load_tuned("fib", "na_ws", cfg=dataclasses.replace(
        cfg, stack_cap=128), **kw) is None
    rec = json.loads(pathlib.Path(path).read_text())
    for field, value in (("code_version", "older-semantics"),
                         ("sim_signature", COMMITTED_SIG)):
        pathlib.Path(path).write_text(json.dumps(dict(rec, **{field: value})))
        assert t_tune.load_tuned("fib", "na_ws", cfg=cfg, **kw) is None
        assert j_tune.load_tuned("fib", "na_ws", cfg=JSimConfig(**SMOKE),
                                 **kw) is None
    pathlib.Path(path).write_text("{not json")
    assert t_tune.load_tuned("fib", "na_ws", **kw) is None


@pytest.mark.parametrize("slot", [
    dict(), dict(topology="dual_socket_24"), dict(arrivals="poisson:2"),
    dict(topology="quad_socket_48", arrivals="bursty:4:8:0.5"),
    dict(topology="two_node_2x24", arrivals="lognormal:3:1.5"),
])
def test_artifact_paths_and_files_equal_jax(slot, tmp_path):
    for smoke, spec in itertools.product((True, False), ("na_rp", "na_ws")):
        assert t_tune.artifact_path("fib", spec, smoke, "d", **slot) \
            == j_tune.artifact_path("fib", spec, smoke, "d", **slot)
    res = dict(params=(3, 16, 300, 0.75), makespan_ns=98765, n_configs=41,
               n_sims=82, seeds=(0, 3), objective="makespan")
    if "arrivals" in slot:
        res.update(objective="p99_latency", p99_ns=4321)
    written = []
    for pkg, cfg in ((t_tune, SimConfig(**CFG)), (j_tune, JSimConfig(**CFG))):
        path = pkg.save_artifact(
            "uts", "na_rp", dict(res, params=pkg.TunedParams(*res["params"])),
            cfg, smoke=False, slb_ns=123456,
            ref=dict(params=dict(n_victim=4), makespan_ns=99999),
            tuned_dir=str(tmp_path / pkg.__name__), **slot)
        written.append(pathlib.Path(path))
    assert written[0].relative_to(tmp_path / t_tune.__name__) \
        == written[1].relative_to(tmp_path / j_tune.__name__)
    assert written[0].read_bytes() == written[1].read_bytes()
    rec = t_tune.load_tuned("uts", "na_rp", smoke=False,
                            cfg=SimConfig(**CFG),
                            tuned_dir=str(tmp_path / t_tune.__name__),
                            **slot)
    assert rec is not None and rec["params"]["n_steal"] == 16


def test_tune_mode_warns_and_matches_tune_spec():
    small = dict(n_victim=(1,), n_steal=(1, 8), t_interval=(10,),
                 p_local=(1.0,))
    with pytest.warns(DeprecationWarning):
        legacy = t_tune.tune_mode(t_tg.fib(8), "na_ws", SimConfig(**CFG),
                                  coarse=small, rounds=0, device="cpu")
    modern = t_tune.tune_spec(t_tg.fib(8), dlb_spec("na_ws"),
                              SimConfig(**CFG), coarse=small, rounds=0,
                              device="cpu")
    assert plain(legacy) == plain(modern)
    with pytest.raises(AssertionError):   # static_rr has no knobs
        t_tune.tune_spec(t_tg.fib(8), SLB_SPEC, SimConfig(**CFG),
                         device="cpu")


def test_ladders_and_neighbors_equal_jax():
    assert t_tune.LADDERS == j_tune.LADDERS
    assert t_tune.COARSE == j_tune.COARSE
    assert t_tune.DEFAULT_TUNED_DIR == j_tune.DEFAULT_TUNED_DIR
    assert [f.name for f in dataclasses.fields(t_tune.TunedParams)] \
        == [f.name for f in dataclasses.fields(j_tune.TunedParams)]
    assert t_tune.TunedParams().asdict() == j_tune.TunedParams().asdict()
    grid = list(itertools.product(*t_tune.LADDERS.values()))
    # off-ladder points: between rungs, past both ends, and a tie
    grid += [(5, 8, 100, 1.0), (3, 3, 65, 0.375), (30, 64, 2000, 0.1),
             (0, 0, 1, 0.0), (6, 12, 200, 0.625), (20, 24, 650, 0.875)]
    for point in grid:
        got = [n.asdict() for n in t_tune._neighbors(
            t_tune.TunedParams(*point))]
        want = [n.asdict() for n in j_tune._neighbors(
            j_tune.TunedParams(*point))]
        assert got == want, point
    # ordering (the search's tie-break) is the knob tuple, in field order
    pts = [t_tune.TunedParams(*p) for p in grid[::37]]
    jpts = [j_tune.TunedParams(*p) for p in grid[::37]]
    assert [p.asdict() for p in sorted(pts)] \
        == [p.asdict() for p in sorted(jpts)]

