"""The port on a CUDA card: each hand-written kernel against its plain
PyTorch twin at the main path's width, the golden cases bitwise on the
``cuda`` and ``cuda_fused`` backends and through the sweep service, and
smoke-config serving (gemma2, rwkv6 and moonshot) on the card against
the CPU, and the hybrid and frontend families (hymba, pixtral, hubert)
through the kernels against their plain twins.  Every
test skips without a card (the kernels have no CPU mode); on one, run them
with

    PYTHONPATH=src python3 -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import scheduler, sweep, xqueue  # noqa: E402
from repro_torch.core.plan import CaseSpec  # noqa: E402
from repro_torch.core.spec import MODE_SPECS, RuntimeSpec  # noqa: E402
from repro_torch.core.state import (CTR_NAMES, SimConfig,  # noqa: E402
                                    batch_of_one, make_params, to_numpy,
                                    tree_map)
from repro_torch.core.taskgraph import build as build_graph  # noqa: E402
from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.core import balance  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402
from repro_torch.kernels import registry as reg  # noqa: E402
from repro_torch.kernels import sched_queue as sq  # noqa: E402
from repro_torch.kernels import sched_step as ss  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

W, Q, NC = 64, 16, 18
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_modes.json")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _queues(rs, device, w=W, q=Q, fill="mixed"):
    """Queues of width ``w`` and capacity ``q``: half empty and half holding
    1..q tasks ("mixed"), every one full, or every one empty."""
    head = rs.integers(0, 40, (w, w)).astype(np.int32)
    size = {"mixed": np.where(rs.random((w, w)) < 0.5, 0,
                              rs.integers(1, q + 1, (w, w))),
            "full": np.full((w, w), q), "empty": np.zeros((w, w))}[fill]
    arrs = dict(buf=rs.integers(-1, 99, (w, w, q)).astype(np.int32),
                ts=rs.integers(0, 9999, (w, w, q)).astype(np.int32),
                head=head, tail=(head + size).astype(np.int32))
    return xqueue.XQ(**{k: torch.as_tensor(v, device=device)
                        for k, v in arrs.items()})


def _equal(a, b, label):
    a, b = to_numpy(a) if hasattr(a, "_fields") else {"": a}, \
        to_numpy(b) if hasattr(b, "_fields") else {"": b}
    for k in b:
        x = a[k] if isinstance(a[k], np.ndarray) else a[k].cpu().numpy()
        y = b[k] if isinstance(b[k], np.ndarray) else b[k].cpu().numpy()
        assert np.array_equal(x, y), (label, k)


def _card(xq):
    return xqueue.XQ(*(x.cuda() for x in xq))


def _launches():
    torch.cuda.synchronize()
    return [reg.KERNELS[k].launches for k in sq.QUEUE_KERNELS]


def _push_lanes(rs, w, n_active, mask_p):
    return [torch.arange(w, dtype=torch.int32),
            torch.as_tensor(rs.integers(0, n_active, w).astype(np.int32)),
            torch.as_tensor(rs.integers(0, 99, w).astype(np.int32)),
            torch.as_tensor(rs.integers(0, 9999, w).astype(np.int32)),
            torch.as_tensor(rs.random(w) < mask_p)]


@pytest.mark.gpu
@pytest.mark.parametrize("q", (4, 16))
@pytest.mark.parametrize("w", (48, 64, 144, 200))
def test_cuda_kernels_match_plain(w, q):
    """Each CUDA kernel against its plain twin, bitwise, at one launch a
    call: push and pop_first on mixed, full and empty queues, with a random
    and an all-false mask, ``n_active`` below the width and None; then 50
    alternating push and pop calls on one queue; ``ctr_add`` once."""
    _need_card()
    rs = np.random.default_rng(w * 100 + q)
    for fill in ("mixed", "full", "empty"):
        cpu = _queues(rs, "cpu", w, q, fill)
        for mask_p in (0.8, 0.0):
            for na in (torch.tensor(w - 3, dtype=torch.int32), None):
                label = (w, q, fill, mask_p, na)
                n = w if na is None else int(na)
                rot = torch.as_tensor(rs.integers(0, 99, w).astype(np.int32))
                mask = torch.as_tensor(rs.random(w) < mask_p)
                reg.reset_launches()
                got = sq.pop_first(_card(cpu), rot.cuda(), mask.cuda(),
                                   None if na is None else na.cuda())
                want = xqueue.pop_first(cpu, rot, mask, na)
                _equal(got[0], want[0], ("pop xq", *label))
                for i, (a, b) in enumerate(zip(got[1:], want[1:])):
                    _equal(a, b, ("pop", i, *label))
                lanes = _push_lanes(rs, w, n, mask_p)
                got = sq.push(_card(cpu), *(x.cuda() for x in lanes))
                want = xqueue.push(cpu, *lanes)
                _equal(got[0], want[0], ("push xq", *label))
                _equal(got[1], want[1], ("push ok", *label))
                assert _launches() == [0, 1, 1], label
    # 50 calls in turn on one queue, the card's in place, the twin's
    # functional
    reg.reset_launches()
    cpu = _queues(rs, "cpu", w, q)
    card = _card(cpu)
    for i in range(50):
        na = None if i % 4 == 1 else torch.tensor(w - i % 3, dtype=torch.int32)
        if i % 2 == 0:
            lanes = _push_lanes(rs, w, w, 0.7)
            card, got_ok = sq.push(card, *(x.cuda() for x in lanes))
            cpu, ok = xqueue.push(cpu, *lanes)
            _equal(got_ok, ok, ("sequence push ok", w, q, i))
        else:
            rot = torch.as_tensor(rs.integers(0, 99, w).astype(np.int32))
            mask = torch.as_tensor(rs.random(w) < 0.9)
            card, *got = sq.pop_first(card, rot.cuda(), mask.cuda(),
                                      None if na is None else na.cuda())
            cpu, *want = xqueue.pop_first(cpu, rot, mask, na)
            for j, (a, b) in enumerate(zip(got, want)):
                _equal(a, b, ("sequence pop", j, w, q, i))
        _equal(card, cpu, ("sequence xq", w, q, i))
    assert _launches() == [0, 25, 25]
    ctr = torch.as_tensor(rs.integers(0, 99, (w, NC)).astype(np.int32))
    val = torch.as_tensor(rs.integers(0, 9, w).astype(np.int32))
    _equal(sq.ctr_add(ctr.cuda(), 5, val.cuda()),
           sq.ctr_add_ref(ctr, 5, val), "ctr_add")
    assert _launches() == [1, 25, 25]


def _bad_push(rs, w, q, which, value, fill, owner_active):
    """A push whose lane 1 (consumer case) or lane 0 (producer case)
    carries an id outside [0, w), on mixed queues whose row that lane's
    ``ok`` reads is all full or all empty; in the producer case every lane
    pushes to consumer 1 and lane w - 1 (the owner of the column a
    producer of -1 wraps to) is active or not."""
    xq = _queues(rs, "cpu", w, q)
    producer = torch.arange(w, dtype=torch.int32)
    consumer = torch.as_tensor(rs.integers(0, w, w).astype(np.int32))
    mask = torch.ones(w, dtype=torch.bool)
    if which == "consumer":
        consumer[1] = value
        row = min(max(value + w if value < 0 else value, 0), w - 1)
    else:
        producer[0] = value
        consumer[:] = 1
        mask[w - 1] = owner_active
        row = 1
    xq.tail[row] = xq.head[row] + (q if fill == "full" else 0)
    return xq, [producer, consumer,
                torch.as_tensor(rs.integers(0, 99, w).astype(np.int32)),
                torch.as_tensor(rs.integers(0, 9999, w).astype(np.int32)),
                mask]


@pytest.mark.gpu
@pytest.mark.parametrize("w,q", [(64, 16), (1024, 4)])
def test_cuda_push_with_ids_outside_the_width_matches_its_twin(w, q):
    """A lane whose consumer (-1, W, -W - 1, 2W) or producer (-1, W) lies
    outside [0, W), on full and empty target rows: the CUDA push equals
    its twin bitwise (which equals the reference's), one counted launch a
    call; W = 1024 is the widest block the kernel takes."""
    _need_card()
    rs = np.random.default_rng(w)
    for which, value in [("consumer", -1), ("consumer", w),
                         ("consumer", -w - 1), ("consumer", 2 * w),
                         ("producer", -1), ("producer", w)]:
        for fill in ("full", "empty"):
            for owner_active in (True, False):
                label = (w, which, value, fill, owner_active)
                cpu, lanes = _bad_push(rs, w, q, which, value, fill,
                                       owner_active)
                reg.reset_launches()
                got = sq.push(_card(cpu), *(x.cuda() for x in lanes))
                want = xqueue.push(cpu, *lanes)
                _equal(got[0], want[0], ("push xq", *label))
                _equal(got[1], want[1], ("push ok", *label))
                assert _launches() == [0, 1, 0], label


@pytest.mark.gpu
def test_pop_first_without_n_active_makes_no_host_copy():
    """``n_active=None`` passes the width by value: the call makes no
    synchronising host-to-device copy (the sync debug mode raises on one)."""
    _need_card()
    rs = np.random.default_rng(7)
    cpu = _queues(rs, "cpu")
    rot = torch.as_tensor(rs.integers(0, 99, W).astype(np.int32))
    mask = torch.as_tensor(rs.random(W) < 0.8)
    card, rot_c, mask_c = _card(cpu), rot.cuda(), mask.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sq.pop_first(card, rot_c, mask_c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = xqueue.pop_first(cpu, rot, mask)
    for i, (a, b) in enumerate(zip(got, want)):
        _equal(a, b, ("pop", i))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_multi_pair_ctr_add_kernel_matches_its_twin(seed):
    """One launch of the counter bump with up to 16 (column, value) pairs
    against its plain twin, bitwise: bool and int32 values, a repeated
    column, and sums that wrap past 2**31."""
    _need_card()
    rs = np.random.default_rng(40 + seed)
    reg.reset_launches()
    ctr = torch.as_tensor(rs.integers(2**31 - 50, 2**31 - 1,
                                      (W, NC)).astype(np.int32))
    cols = [int(c) for c in rs.integers(0, NC, 14)] + [3, 3]
    pairs = [(c, torch.as_tensor(rs.random(W) < 0.5) if i % 2 else
              torch.as_tensor(rs.integers(-99, 99, W).astype(np.int32)))
             for i, c in enumerate(cols)]
    got = sq.ctr_add(ctr.cuda(), [(c, v.cuda()) for c, v in pairs])
    _equal(got, sq.ctr_add_ref(ctr, pairs), ("ctr_add pairs", seed))
    torch.cuda.synchronize()
    assert reg.KERNELS["ctr_add"].launches == 1


@pytest.mark.gpu
def test_goldens_bitwise_on_the_card():
    """The 10 golden cases on the ``cuda`` backend, bitwise, with every
    kernel launched."""
    _need_card()
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    cfg = dataclasses.replace(SimConfig(**golden["cfg"]), backend="cuda")
    reg.reset_launches()
    for c in golden["cases"]:
        family, kw = golden["graphs"][c["graph"]]
        r = scheduler.run_schedule(
            build_graph(family, **kw), spec=RuntimeSpec.from_mode(c["mode"]),
            cfg=cfg, params=make_params(**golden["knobs"], device="cuda"))
        label = (c["graph"], c["mode"])
        assert r.completed and r.time_ns == c["time_ns"], label
        assert r.steps == c["steps"], label
        for name in CTR_NAMES:
            assert r.counters[name] == c["counters"].get(name, 0), \
                (*label, name)
    assert all(reg.KERNELS[k].launches > 0 for k in sq.QUEUE_KERNELS)


def _golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", (None, "quad_socket_48",
                                      "two_node_2x24"))
@pytest.mark.parametrize("mode", ("gomp", "na_rp", "na_ws"))
def test_fused_step_matches_its_twin(mode, topology):
    """``sched_step`` with ``max_iters=1`` against its plain twin on
    mid-run states at W = 16, every leaf bitwise."""
    _need_card()
    graph = build_graph("fib", n=9)
    if topology == "two_node_2x24":
        graph = graph.with_payload(8.0)
    params = dict(n_victim=2, n_steal=4, t_interval=5, p_local=0.7)
    for k in (3, 9, 20):
        cfg = SimConfig(n_workers=16, n_zones=4, max_steps=k,
                        backend="reference")
        r = scheduler.run(graph, spec=MODE_SPECS[mode], cfg=cfg, seed=k,
                          topology=topology,
                          params=make_params(**params, device="cuda"),
                          device="cuda")
        st, g, case = (batch_of_one(x) for x in (r.state, r.graph, r.case))
        want = ss.run_lanes(tree_map(torch.clone, st), g, case,
                            costs=cfg.costs, max_steps=60_000, max_iters=1)
        got = ss.sched_step(tree_map(torch.clone, st), g, case,
                            costs=cfg.costs, max_steps=60_000, max_iters=1)
        torch.cuda.synchronize()
        _equal(got, want, (mode, topology, k))


@pytest.mark.gpu
@pytest.mark.parametrize("W,topology", ((64, None), (144, "quad_socket_48"),
                                        (200, None)))
def test_fused_kernel_matches_its_twin_at_each_instantiation(W, topology):
    """The fused kernel's three shapes against the twin, every leaf
    bitwise: W = 64 (128 threads, heads and tails in shared memory), 144
    (1024 threads, in shared memory), 200 (1024 threads, in device memory);
    mid-run NA-WS states one step at a time, then a whole run."""
    _need_card()
    assert ss.resident(W) == (W <= 156)
    graph = build_graph("fib", n=10)
    params = dict(n_victim=3, n_steal=4, t_interval=5, p_local=0.7)
    for k in (3, 12):
        cfg = SimConfig(n_workers=W, n_zones=4, max_steps=k,
                        backend="reference")
        r = scheduler.run(graph, spec=MODE_SPECS["na_ws"], cfg=cfg, seed=k,
                          topology=topology,
                          params=make_params(**params, device="cuda"),
                          device="cuda")
        st, g, case = (batch_of_one(x) for x in (r.state, r.graph, r.case))
        want = ss.run_lanes(tree_map(torch.clone, st), g, case,
                            costs=cfg.costs, max_steps=60_000, max_iters=1)
        got = ss.sched_step(tree_map(torch.clone, st), g, case,
                            costs=cfg.costs, max_steps=60_000, max_iters=1)
        torch.cuda.synchronize()
        _equal(got, want, (W, topology, k))
    runs = {b: scheduler.run(graph, spec=MODE_SPECS["na_ws"],
                             cfg=SimConfig(n_workers=W, n_zones=4,
                                           backend=b),
                             topology=topology,
                             params=make_params(**params, device="cuda"),
                             device="cuda")
            for b in ("cuda_fused", "reference")}
    _equal(runs["cuda_fused"].state, runs["reference"].state, (W, "run"))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ("serial", "batched", "sharded"))
def test_goldens_through_run_cases_on_cuda_fused(strategy):
    """The 10 goldens through the sweep service on ``cuda_fused``, one
    kernel launch per case (serial), per chunk (batched), or per chunk and
    card (sharded, one launch per card where several are visible)."""
    _need_card()
    golden = _golden()
    cfg = SimConfig(**golden["cfg"])
    names = list(golden["graphs"])
    graphs = [build_graph(f, **kw) for f, kw in golden["graphs"].values()]
    specs = [CaseSpec(spec=RuntimeSpec.from_mode(c["mode"]),
                      n_workers=cfg.n_workers, n_zones=cfg.n_zones,
                      graph=names.index(c["graph"]), **golden["knobs"])
             for c in golden["cases"]]
    reg.reset_launches()
    res = sweep.run_cases(graphs, specs, cfg=cfg, strategy=strategy)
    assert res.completed.all()
    for i, c in enumerate(golden["cases"]):
        label = (strategy, c["graph"], c["mode"])
        assert int(res.time_ns[i]) == c["time_ns"], label
        assert int(res.steps[i]) == c["steps"], label
        for name in CTR_NAMES:
            assert int(res.counters[name][i]) == c["counters"].get(name, 0), \
                (*label, name)
    n_chunks = len({c["mode"] for c in golden["cases"]})
    n_cards = torch.cuda.device_count() if strategy == "sharded" else 1
    want = len(specs) if strategy == "serial" else n_chunks * n_cards
    assert reg.KERNELS["sched_step"].launches == want


@pytest.mark.gpu
def test_sharded_sweep_runs_on_every_card_at_w96():
    """The sharded executor (what ``auto`` takes on ``cuda_fused`` when
    several cards are visible) launches the fused kernel once on each card.
    At W = 96 on ``two_node_2x24`` a block takes more than the default
    48 KB of dynamic shared memory, a cap each card's context raises for
    itself.  The results equal the serial executor's, case for case."""
    _need_card()
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        pytest.skip("needs two or more CUDA devices")
    graph = build_graph("fib", n=10)
    specs = [CaseSpec(spec=MODE_SPECS["na_ws"], n_workers=96, seed=s,
                      topology="two_node_2x24") for s in range(2 * n_dev)]
    cfg = SimConfig(backend="cuda_fused")
    reg.reset_launches()
    got = sweep.run_cases(graph, specs, cfg=cfg, strategy="sharded")
    assert reg.KERNELS["sched_step"].launches == n_dev
    want = sweep.run_cases(graph, specs, cfg=cfg, strategy="serial")
    assert got.completed.all() and want.completed.all()
    assert np.array_equal(got.time_ns, want.time_ns)
    assert np.array_equal(got.steps, want.steps)
    for name in CTR_NAMES:
        assert np.array_equal(got.counters[name], want.counters[name]), name


#: (B, H, KV, S, Dh, dtype, window, softcap): the serving shape with and
#: without its window, a window that bites, ragged sequences, a small head;
#: the bf16 (wgmma) path at every head dim, S = 1, 129 and 1000, and a
#: window of 200 over S = 1000
FLASH_SHAPES = {
    "serve_local": (4, 8, 4, 1024, 256, "bfloat16", 4096, 50.0),
    "serve_full": (4, 8, 4, 1024, 256, "bfloat16", 0, 50.0),
    "window_bf16": (1, 8, 4, 8192, 256, "bfloat16", 4096, 50.0),
    "window_f32": (1, 8, 4, 8192, 256, "float32", 4096, 50.0),
    "ragged_64": (2, 4, 2, 1000, 64, "bfloat16", 0, None),
    "ragged_128": (2, 4, 2, 1000, 128, "float32", 300, None),
    "small_f32": (2, 4, 4, 96, 16, "float32", 0, 20.0),
    "head_192": (1, 4, 1, 300, 192, "bfloat16", 100, None),
    "moonshot": (4, 16, 16, 1024, 128, "bfloat16", 0, None),
    "s1_256": (1, 2, 1, 1, 256, "bfloat16", 0, 50.0),
    "s129_256": (1, 4, 2, 129, 256, "bfloat16", 0, 50.0),
    "s1000_256": (2, 4, 2, 1000, 256, "bfloat16", 0, 50.0),
    "window_mid": (1, 4, 2, 1000, 256, "bfloat16", 200, 50.0),
    "s1000_192": (1, 4, 2, 1000, 192, "bfloat16", 0, 50.0),
    "dh32_bf16": (2, 4, 4, 300, 32, "bfloat16", 0, None),
    "dh16_bf16": (2, 4, 2, 200, 16, "bfloat16", 0, 20.0),
}


def _flash_inputs(B, H, KV, S, Dh, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, n, S, Dh), generator=gen, device="cuda"
                             ).to(getattr(torch, dtype)) for n in (H, KV, KV))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
def test_flash_kernel_matches_its_twin(shape):
    """The CUDA flash-attention forward against its plain twin, one
    launch per call; 2e-2 (atol and rtol) on bf16 outputs, 1e-4 on f32."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, KV, S, Dh, dtype, window, softcap = FLASH_SHAPES[shape]
    q, k, v = _flash_inputs(B, H, KV, S, Dh, dtype)
    reg.reset_launches()
    got = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert reg.KERNELS["flash_attention"].launches == 1
    want = ref.flash_attention(q, k, v, True, window, softcap)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)



@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_without_the_causal_mask(dtype):
    """Both kernels with ``causal=False`` (every key visible, and a window
    on both sides) against the twin, at a ragged S."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(1, 4, 2, 300, 128, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for window in (0, 100):
        got = fa.flash_attention(q, k, v, causal=False, window=window)
        want = ref.flash_attention(q, k, v, False, window, None)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_gives_the_same_bits_twice(dtype):
    """No atomics: two calls on the same inputs are bitwise equal."""
    _need_card()
    q, k, v = _flash_inputs(4, 8, 4, 1024, 256, dtype)
    first = fa.flash_attention(q, k, v, softcap=50.0)
    second = fa.flash_attention(q, k, v, softcap=50.0)
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh,dtype", [(d, "bfloat16") for d in fa.HEAD_DIMS]
                         + [(256, "float32")])
def test_flash_kernel_never_reads_the_next_head(Dh, dtype):
    """KV head 1's V all inf at a ragged S: the query heads of KV head 0
    stay finite and bitwise equal to what they give alone, so no tile
    reads past S into the next head (0 * inf would be NaN).  The twin's
    oracle is in ``tests/test_torch_attention.py``."""
    _need_card()
    B, H, KV, S = 1, 4, 2, 1000
    q, k, v = _flash_inputs(B, H, KV, S, Dh, dtype)
    v[:, 1] = float("inf")
    rep = H // KV
    got = fa.flash_attention(q, k, v, softcap=50.0)[:, :rep]
    alone = fa.flash_attention(q[:, :rep].contiguous(), k[:, :1].contiguous(),
                               v[:, :1].contiguous(), softcap=50.0)
    assert torch.isfinite(got).all()
    assert torch.equal(got, alone)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_at_head_dim_80(dtype, causal):
    """hubert_xlarge's head dim: five 16-column boxes on the wgmma path,
    five columns a thread on the FMA path; every column against the twin,
    at hubert's shape and at a ragged S with and without a window that
    bites (2e-2 on bf16, 1e-4 on float32)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for (B, H, KV, S), window in (((2, 16, 16, 1024), 0),
                                  ((2, 4, 2, 1000), 0),
                                  ((1, 4, 2, 1000), 100)):
        q, k, v = _flash_inputs(B, H, KV, S, 80, dtype)
        reg.reset_launches()
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert reg.KERNELS["flash_attention"].launches == 1
        want = ref.flash_attention(q, k, v, causal, window, None)
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        # the last 16 columns (past one 64-column box) carry the values
        assert float(got[..., 64:].float().abs().max()) > 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba_1_5b", "pixtral_12b",
                                  "hubert_xlarge"])
def test_smoke_hybrid_and_frontend_models_through_the_kernels(arch):
    """The smoke models on the card through the kernels against the plain
    twins (``set_impl("ref")``) on the same weights: one flash launch per
    layer; hymba's and pixtral's prefill and 3 decode steps (the SSM state
    and conv carry, the patches counted in ``length``), hubert's encoder
    logits at every position; 1e-4 (float32 smoke configs)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import ops

    cfg = cb.smoke_config(arch)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             "cpu").cuda()
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in batch_for(cfg, 0, 2, 40).items() if k != "targets"}
    steps = torch.randint(0, cfg.vocab, (2, 3),
                          generator=torch.Generator().manual_seed(1)).cuda()
    runs = {}
    for impl in (None, "ref"):
        ops.set_impl(impl)
        reg.reset_launches()
        try:
            with torch.inference_mode():
                if cfg.encoder_only:
                    seq = [tfm.forward(params, cfg, batch)[0]]
                else:
                    last, state = tfm.prefill(params, cfg, batch, 43)
                    assert state.length.tolist() == [40, 40]
                    seq = [last]
                    for t in range(3):
                        step, state = tfm.decode_step(params, cfg, state,
                                                      steps[:, t])
                        seq.append(step)
        finally:
            ops.set_impl(None)
        torch.cuda.synchronize()
        runs[impl] = (seq, reg.KERNELS["flash_attention"].launches)
    assert runs[None][1] == cfg.n_layers and runs["ref"][1] == 0
    for a, b in zip(runs[None][0], runs["ref"][0]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_smoke_serving_on_the_card_matches_the_cpu():
    """gemma2 smoke weights served on the card and on the CPU: the same
    greedy ids and close prefill logits; one kernel launch per attention
    layer of the prefill and none while decoding."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cb.smoke_config("gemma2_2b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params.embed.mul_(0.02)   # greedy ids that vary (see test_torch_serve)
    tok = torch.randint(0, cfg.vocab, (3, 40),
                        generator=torch.Generator().manual_seed(1))
    cpu = serve.generate(params, cfg, {"tokens": tok}, 12)
    reg.reset_launches()
    card = serve.generate(params.cuda(), cfg, {"tokens": tok.cuda()}, 12)
    assert card.launches["prefill"] == dict(
        dict.fromkeys(reg.KERNELS, 0), flash_attention=cfg.n_layers)
    assert card.launches["decode"] == dict.fromkeys(reg.KERNELS, 0)
    assert reg.KERNELS["flash_attention"].launches == cfg.n_layers
    torch.testing.assert_close(card.prefill_logits.cpu(),
                               cpu.prefill_logits, atol=1e-4, rtol=1e-4)
    assert torch.equal(card.ids.cpu(), cpu.ids)


#: (B, H, T, Dh, dtype, initial state, decays, layout): the serving shape,
#: a float32 run from a nonzero state with sigmoid decays, a ragged T, one
#: step, the small heads and a long sequence; then the kernel's edges: one
#: (b, h) at each head dim, T on either side of one and two tiles (32 steps
#: at Dh = 64, 16 at Dh = 16 and 32), decays near 1 (sigmoid of +6) and near
#: 0 (of -6), and the model's (B, T, H, Dh) layout at H = 32, Dh = 64
RWKV_SHAPES = {
    "serve_bf16": (1, 32, 1024, 64, "bfloat16", False, None, "packed"),
    "f32_state": (2, 4, 256, 64, "float32", True, None, "packed"),
    "ragged_1000": (1, 8, 1000, 64, "bfloat16", True, None, "packed"),
    "one_step": (2, 8, 1, 64, "float32", True, None, "packed"),
    "dh16": (2, 4, 96, 16, "float32", True, None, "packed"),
    "dh32": (2, 2, 128, 32, "bfloat16", True, None, "packed"),
    "long_8192": (1, 4, 8192, 64, "bfloat16", False, None, "packed"),
    "b1h1_dh16": (1, 1, 37, 16, "float32", True, None, "packed"),
    "b1h1_dh32": (1, 1, 37, 32, "bfloat16", True, None, "packed"),
    "b1h1_dh64": (1, 1, 37, 64, "float32", True, None, "packed"),
    "one_step_bf16": (2, 4, 1, 64, "bfloat16", True, None, "packed"),
    **{f"t{t}": (2, 4, t, 64, "float32", True, None, "packed")
       for t in (31, 32, 33, 63, 64, 65)},
    "t32_bf16": (2, 4, 32, 64, "bfloat16", True, None, "packed"),
    "t65_bf16": (2, 4, 65, 64, "bfloat16", True, None, "model"),
    **{f"t{t}_dh{dh}": (2, 3, t, dh, dtype, True, None, layout)
       for dh, dtype, layout in ((16, "bfloat16", "packed"),
                                 (32, "float32", "model"))
       for t in (15, 16, 17, 31, 32, 33)},
    "decay_near1": (2, 4, 200, 64, "float32", True, "near1", "packed"),
    "decay_near0": (2, 4, 200, 64, "bfloat16", True, "near0", "packed"),
    "model_h32": (2, 32, 300, 64, "bfloat16", True, None, "model"),
    "unaligned_rows": (2, 4, 70, 64, "bfloat16", True, None, "padded"),
}
#: decays drawn near 1 or near 0: sigmoid of +6 or -6, a little spread
DECAY_CENTRE = {None: 0.0, "near1": 6.0, "near0": -6.0}


def rwkv_inputs(B, H, T, Dh, dtype, nonzero_state, device, seed=0,
                decay=None, layout="packed"):
    """r, k, v, w, u, state as the JAX package's kernel test draws them:
    k and v scaled by 0.3, sigmoid decays, u and the state by 0.1.  With
    ``decay`` the decays are sigmoid(6 + 0.1 z) ("near1") or sigmoid(-6 +
    0.1 z) ("near0"); in the "model" layout r, k, v, w are (B, T, H, Dh)
    buffers viewed as (B, H, T, Dh), in the "padded" one the first Dh of
    (B, H, T, Dh + 1) rows (rows the kernel cannot read four at a time)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    dt = getattr(torch, dtype)
    r = randn(B, H, T, Dh).to(dt)
    k = (randn(B, H, T, Dh) * 0.3).to(dt)
    v = (randn(B, H, T, Dh) * 0.3).to(dt)
    z = randn(B, H, T, Dh)
    w = torch.sigmoid(z if decay is None else DECAY_CENTRE[decay] + 0.1 * z
                      ).to(dt)
    u = randn(H, Dh) * 0.1
    state = randn(B, H, Dh, Dh) * 0.1 if nonzero_state else \
        torch.zeros((B, H, Dh, Dh), device=device)
    if layout == "model":
        r, k, v, w = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (r, k, v, w))
    elif layout == "padded":
        r, k, v, w = (torch.nn.functional.pad(x, (0, 1))[..., :Dh]
                      for x in (r, k, v, w))
    return r, k, v, w, u, state


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(RWKV_SHAPES))
def test_rwkv6_kernel_matches_its_twin(shape):
    """The CUDA RWKV6 recurrence against its plain twin, output and final
    state, one launch per call, out in the inputs' layout; 2e-2 (atol and
    rtol) on bf16 outputs, 1e-4 on float32 outputs and on every final
    state."""
    _need_card()
    B, H, T, Dh, dtype, nonzero, decay, layout = RWKV_SHAPES[shape]
    args = rwkv_inputs(B, H, T, Dh, dtype, nonzero, "cuda", decay=decay,
                       layout=layout)
    reg.reset_launches()
    out, state = rk.rwkv6(*args)
    torch.cuda.synchronize()
    assert reg.KERNELS["rwkv6_scan"].launches == 1
    want, want_state = rk.plain(*args)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert out.dtype == args[0].dtype and state.dtype == torch.float32
    if layout != "padded":                  # packed where r has gaps
        assert out.stride() == args[0].stride()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_rwkv6_launch_fills_the_card():
    """At the serving shape (B = 4, H = 32, Dh = 64) each (b, h) spans
    more than one block and the grid has a block for every SM."""
    _need_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = rk.launch_shape(4, 32, 64)
    assert shape["blocks"] >= sms and shape["blocks"] > 4 * 32, shape


#: the head of ``write_out``'s loop in ``csrc/rwkv6_scan.cu``, where
#: :func:`test_rwkv6_load_warps_wait_for_each_other` puts its delay
_WRITE_OUT_LOOP = "  for (int j = lt; j < n * RC; j += C::NL) {\n"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rwkv6_load_warps_wait_for_each_other(dtype, monkeypatch):
    """At Dh = 64 a load warp fills a buffer with rows of v and a_t that
    the other load warps read while they write out the buffer's last tile.
    A copy of the kernel in which every load warp but the first sleeps
    20 us before each write-out still matches the twin (2e-2 on bf16
    outputs, 1e-4 on float32 outputs and the final state), one launch:
    the fill waits for every load warp."""
    _need_card()
    src = rk.SOURCE.read_text()
    assert src.count(_WRITE_OUT_LOOP) == 1
    path = reg.BUILD_ROOT / "rwkv6_delayed" / "rwkv6_scan.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(
        _WRITE_OUT_LOOP,
        "  if (lt >= 32) __nanosleep(20000);\n" + _WRITE_OUT_LOOP))
    lib = rk.bind(reg.build(path)[0])
    monkeypatch.setattr(rk, "_library", lambda: lib)
    args = rwkv_inputs(1, 2, 250, 64, dtype, True, "cuda", layout="model")
    reg.reset_launches()
    out, state = rk.rwkv6(*args)
    torch.cuda.synchronize()
    assert reg.KERNELS["rwkv6_scan"].launches == 1
    want, want_state = rk.plain(*args)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 8, 200, 64), (2, 32, 1024, 64)])
def test_rwkv6_kernel_reads_the_models_layout(shape):
    """(B, T, H, Dh) buffers viewed as (B, H, T, Dh) go through the kernel
    as they lie, and out comes back in the same layout, equal to the run
    on packed copies and within 2e-2 of the twin."""
    _need_card()
    B, H, T, Dh = shape
    r, k, v, w, u, state = rwkv_inputs(B, H, T, Dh, "bfloat16", True, "cuda")
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (r, k, v, w)]
    assert not views[0].is_contiguous()
    out, s = rk.rwkv6(*views, u, state)
    packed, s_packed = rk.rwkv6(r, k, v, w, u, state)
    want, want_state = rk.plain(*views, u, state)
    torch.cuda.synchronize()
    assert out.stride() == views[0].stride()
    assert torch.equal(out, packed) and torch.equal(s, s_packed)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(s, want_state, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="one layout"):
        rk.rwkv6(views[0], k, v, w, u, state)


def _rwkv_smoke_params(cfg):
    """Smoke rwkv6 weights with the token-shift mixes, norms and decay base
    drawn away from their zero / constant init, so that every path of the
    block is exercised."""
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(7)
    for name, p in params.named_parameters():
        leaf = name.split(".")[-1]
        if leaf.startswith("mu_") or leaf in ("cm_mu", "ln_x", "ln1", "ln2"):
            p.copy_(torch.rand(p.shape, generator=gen))
        elif leaf == "w_base":
            p.add_(torch.randn(p.shape, generator=gen))
    return params


@pytest.mark.gpu
def test_smoke_rwkv_serving_on_the_card_matches_the_cpu():
    """rwkv6 smoke weights served on the card and on the CPU: the same
    greedy ids and close prefill logits; one kernel launch per RWKV layer
    of the prefill and none while decoding."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cb.smoke_config("rwkv6_1_6b")
    params = _rwkv_smoke_params(cfg)
    tok = torch.randint(0, cfg.vocab, (3, 40),
                        generator=torch.Generator().manual_seed(1))
    cpu = serve.generate(params, cfg, {"tokens": tok}, 12)
    reg.reset_launches()
    card = serve.generate(params.cuda(), cfg, {"tokens": tok.cuda()}, 12)
    assert cfg.n_layers == 2
    assert card.launches["prefill"] == dict(
        dict.fromkeys(reg.KERNELS, 0), rwkv6_scan=2)
    assert card.launches["decode"] == dict.fromkeys(reg.KERNELS, 0)
    torch.testing.assert_close(card.prefill_logits.cpu(),
                               cpu.prefill_logits, atol=1e-4, rtol=1e-4)
    assert torch.equal(card.ids.cpu(), cpu.ids)


#: (T, D, k, E, C, dtype, token groups): moonshot's prefill and decode
#: shapes, float32, a T that is not a multiple of 256, top-1, a capacity
#: that drops most slots, two token groups (G * E = 128 buffers), an odd row
MOE_SHAPES = {
    "prefill": (4096, 2048, 6, 64, 480, "bfloat16", 1),
    "decode": (4, 2048, 6, 64, 8, "bfloat16", 1),
    "f32": (512, 256, 2, 16, 80, "float32", 1),
    "ragged_1000": (1000, 2048, 6, 64, 120, "bfloat16", 1),
    "top1": (256, 512, 1, 8, 40, "bfloat16", 1),
    "tight": (1024, 1024, 6, 64, 16, "bfloat16", 1),
    "groups_2": (2048, 2048, 6, 64, 240, "bfloat16", 2),
    "odd_row": (100, 13, 2, 8, 32, "bfloat16", 1),
}


def moe_inputs(T, D, k, E, C, dtype, G, device, seed=0):
    """x and the (virtual expert, pos) tables of the port's own NA-RP
    routing of random logits, as ``models.moe`` hands them to the
    dispatch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((T, D), generator=gen, device=device).to(
        getattr(torch, dtype))
    logits = torch.randn((T, E), generator=gen, device=device) * 2.0
    tg = torch.arange(T, dtype=torch.int32, device=device) // (T // G)
    r = balance.route(logits, k, C, balance.default_expert_groups(
        E, min(E, 16), device), token_group=tg, n_token_groups=G)
    ve = torch.where(r.expert >= 0, tg[:, None] * E + r.expert, -1)
    return x, ve, r.pos


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(MOE_SHAPES))
def test_moe_dispatch_kernel_matches_its_twin(shape):
    """The CUDA MoE dispatch against its plain twin, bit for bit (the
    kernel only moves data), one launch per call."""
    _need_card()
    T, D, k, E, C, dtype, G = MOE_SHAPES[shape]
    x, ve, pos = moe_inputs(T, D, k, E, C, dtype, G, "cuda")
    reg.reset_launches()
    got = md.moe_dispatch(x, ve, pos, n_experts=G * E, capacity=C)
    torch.cuda.synchronize()
    assert reg.KERNELS["moe_dispatch"].launches == 1
    want = ref.moe_dispatch(x, ve, pos, G * E, C)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if shape == "tight":
        assert int((ve < 0).sum()) > ve.numel() // 2


@pytest.mark.gpu
def test_moe_dispatch_kernel_keeps_the_highest_token_of_a_shared_row():
    """Off the routing path: of slots that share a row the kernel keeps the
    highest token's row (the Pallas kernel's last write), where the twin
    sums them; negative and out-of-range slots are dropped by both; an
    offset view of x is copied in narrower units."""
    _need_card()
    T, D, E, C = 8, 64, 2, 4
    x = torch.randn((T + 1, D), device="cuda")[1:]
    ve = torch.tensor([[0, 1], [0, -1], [1, 2], [-1, 0], [1, 1], [0, 0],
                       [2, 1], [1, 0]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([[0, 0], [1, 0], [3, 0], [2, -1], [0, 9], [1, 2],
                        [0, 1], [3, 3]], dtype=torch.int32, device="cuda")
    got = md.moe_dispatch(x, ve, pos, n_experts=E, capacity=C).reshape(
        E * C, D)
    want = torch.zeros((E * C, D), device="cuda")
    # row -> the highest token among its slots; row 6 has none, and the
    # slots of rows past E * C - 1 are dropped
    for row, t in {0: 0, 1: 5, 2: 5, 3: 7, 4: 4, 5: 6, 7: 7}.items():
        want[row] = x[t]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert md.vec_bytes(x.data_ptr(), got.data_ptr(), D * 4) == 16
    # rows of 12 bytes from an address 4 bytes past a 16-byte boundary:
    # copied 4 bytes at a time; equal to the twin on the rows of one slot
    odd = x.reshape(-1)[1:1 + T * 3].reshape(T, 3)
    assert md.vec_bytes(odd.data_ptr(), 0, 12) == 4
    clamped = pos.clamp(max=C - 1)
    got = md.moe_dispatch(odd, ve, clamped, n_experts=E, capacity=C)
    twin = ref.moe_dispatch(odd, ve, clamped, E, C)
    one_slot = torch.tensor([0, 2, 3, 5, 6], device="cuda")
    assert torch.equal(got.reshape(-1, 3)[one_slot],
                       twin.reshape(-1, 3)[one_slot])


@pytest.mark.gpu
def test_smoke_moe_serving_on_the_card_matches_the_cpu():
    """moonshot smoke weights served on the card and on the CPU: the same
    greedy ids and close prefill logits; per MoE layer one dispatch launch
    in the prefill and one in every decode step, and one flash launch per
    attention layer of the prefill."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cb.smoke_config("moonshot_v1_16b_a3b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab, (3, 40),
                        generator=torch.Generator().manual_seed(1))
    cpu = serve.generate(params, cfg, {"tokens": tok}, 12)
    reg.reset_launches()
    card = serve.generate(params.cuda(), cfg, {"tokens": tok.cuda()}, 12)
    n = cfg.n_layers
    zero = dict.fromkeys(reg.KERNELS, 0)
    assert card.launches["prefill"] == dict(zero, flash_attention=n,
                                            moe_dispatch=n)
    assert card.launches["decode"] == dict(zero, moe_dispatch=n * 11)
    torch.testing.assert_close(card.prefill_logits.cpu(),
                               cpu.prefill_logits, atol=1e-4, rtol=1e-4)
    assert torch.equal(card.ids.cpu(), cpu.ids)
