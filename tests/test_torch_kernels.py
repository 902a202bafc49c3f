"""The port's queue kernels (``repro_torch.kernels.sched_queue``) against
the JAX package's Pallas kernels (``repro.kernels.sched_queue``, run in
interpret mode on the CPU), bitwise.

On CPU tensors each wrapper runs its plain PyTorch twin after the same
argument checks the CUDA path makes; ``tests/test_torch_gpu.py`` holds the
CUDA kernels against the twins on the card.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import xqueue as j_xq  # noqa: E402
from repro.kernels import sched_queue as j_sq  # noqa: E402
from repro_torch.core import phases as t_ph  # noqa: E402
from repro_torch.core import xqueue as t_xq  # noqa: E402
from repro_torch.core.state import to_numpy  # noqa: E402
from repro_torch.kernels import registry as t_reg  # noqa: E402
from repro_torch.kernels import sched_queue as t_sq  # noqa: E402

W, Q, NC = 8, 4, 18


def queues(rs, w=W):
    head = rs.integers(0, 40, (w, w)).astype(np.int32)
    size = rs.integers(0, Q + 1, (w, w)).astype(np.int32)
    size = np.where(rs.random((w, w)) < 0.5, 0, size).astype(np.int32)
    return dict(buf=rs.integers(-1, 99, (w, w, Q)).astype(np.int32),
                ts=rs.integers(0, 9999, (w, w, Q)).astype(np.int32),
                head=head, tail=(head + size).astype(np.int32))


def tq(d):
    return t_xq.XQ(**{k: torch.as_tensor(v.copy()) for k, v in d.items()})


def jq(d):
    return j_xq.XQ(**{k: jnp.asarray(v) for k, v in d.items()})


def eq(a, b, label):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert np.array_equal(a, np.asarray(b)), label


@pytest.mark.parametrize("seed", range(4))
def test_ctr_add_matches_pallas(seed):
    rs = np.random.default_rng(seed)
    ctr = rs.integers(-50, 50, (W, NC)).astype(np.int32)
    val = rs.integers(-9, 9, W).astype(np.int32)
    for col in (0, 7, NC - 1):
        out = t_sq.ctr_add(torch.as_tensor(ctr), col, torch.as_tensor(val))
        eq(out, j_sq.ctr_add(jnp.asarray(ctr), col, jnp.asarray(val)),
           ("ctr_add", seed, col))


#: the widths of the parity tests: the unit tests' 8, and 33, which is not
#: a multiple of a warp (the kernels stride a warp's lanes over producers)
WIDTHS = (W, 33)


@pytest.mark.parametrize("seed", range(4))
def test_push_matches_pallas(seed):
    rs = np.random.default_rng(10 + seed)
    for w in WIDTHS:
        d = queues(rs, w)
        n_active = int(rs.integers(1, w + 1))
        producer = np.arange(w, dtype=np.int32)
        consumer = rs.integers(0, n_active, w).astype(np.int32)
        task = rs.integers(0, 99, w).astype(np.int32)
        ts = rs.integers(0, 9999, w).astype(np.int32)
        mask = (rs.random(w) < 0.8) & (producer < n_active)
        lanes = [producer, consumer, task, ts, mask]
        t_out, t_ok = t_sq.push(tq(d), *map(torch.as_tensor, lanes))
        j_out, j_ok = j_sq.push(jq(d), *map(jnp.asarray, lanes))
        for k, v in to_numpy(j_out).items():
            eq(to_numpy(t_out)[k], v, ("push", seed, w, k))
        eq(t_ok, j_ok, ("push ok", seed, w))


@pytest.mark.parametrize("seed", range(4))
def test_pop_first_matches_pallas(seed):
    """At both widths, with ``n_active`` below the width and with None (the
    width)."""
    rs = np.random.default_rng(20 + seed)
    for w in WIDTHS:
        d = queues(rs, w)
        n_active = int(rs.integers(1, w + 1))
        rot = rs.integers(0, 40, w).astype(np.int32)
        for na in (n_active, None):
            mask = (rs.random(w) < 0.8) & (np.arange(w) < (na or w))
            t_out = t_sq.pop_first(
                tq(d), torch.as_tensor(rot), torch.as_tensor(mask),
                None if na is None else torch.tensor(na, dtype=torch.int32))
            j_out = j_sq.pop_first(jq(d), jnp.asarray(rot), jnp.asarray(mask),
                                   None if na is None else jnp.int32(na))
            label = ("pop", seed, w, na)
            for k, v in to_numpy(j_out[0]).items():
                eq(to_numpy(t_out[0])[k], v, (*label, k))
            for i, (a, b) in enumerate(zip(t_out[1:], j_out[1:])):
                eq(a, b, (*label, i))


def test_cpu_wrappers_check_arguments_and_never_count():
    t_reg.reset_launches()
    rs = np.random.default_rng(0)
    ctr = torch.zeros((W, NC), dtype=torch.int32)
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, 0, torch.zeros(W, dtype=torch.int64))
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr, 0, torch.zeros(W + 1, dtype=torch.int32))
    with pytest.raises(IndexError):
        t_sq.ctr_add(ctr, NC, torch.zeros(W, dtype=torch.int32))
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr.t().contiguous().t(), 0,
                     torch.zeros(W, dtype=torch.int32))
    q = tq(queues(rs))
    lane = torch.zeros(W, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_sq.push(q, lane, lane, lane, lane, lane)        # int mask
    with pytest.raises(ValueError):
        t_sq.pop_first(q, lane, lane.bool(), torch.tensor([W]).int())
    t_sq.ctr_add(ctr, 0, torch.ones(W, dtype=torch.int32))
    t_sq.pop_first(q, lane, lane.bool())
    assert all(k.launches == 0 for k in t_reg.KERNELS.values())


def _pairs(rs):
    """A run of bumps as the phases issue them: bool and int32 values, a
    repeated column, and an int32 sum that wraps past 2**31."""
    cols = [int(c) for c in rs.integers(0, NC, int(rs.integers(2, 14)))]
    cols += [cols[0], NC - 1]
    pairs = []
    for i, col in enumerate(cols):
        if i % 3 == 0:
            pairs.append((col, rs.random(W) < 0.5))
        else:
            pairs.append((col, rs.integers(-9, 9, W).astype(np.int32)))
    pairs.append((NC - 1, np.full(W, 2**31 - 1, np.int32)))
    return pairs


@pytest.mark.parametrize("seed", range(4))
def test_multi_pair_ctr_add_matches_a_sequence_of_pallas_calls(seed):
    """One ``ctr_add`` call with many ``(col, val)`` pairs equals the JAX
    package's one-column ``ctr_add`` called once per pair in order (bools
    cast to int32 as its ``_bump`` does), bitwise, wraps included."""
    rs = np.random.default_rng(30 + seed)
    ctr = rs.integers(-50, 50, (W, NC)).astype(np.int32)
    ctr[:, NC - 1] = 2**31 - 5
    pairs = _pairs(rs)
    want = jnp.asarray(ctr)
    for col, v in pairs:
        want = j_sq.ctr_add(want, col, jnp.asarray(v).astype(jnp.int32))
    t_pairs = [(col, torch.as_tensor(v)) for col, v in pairs]
    eq(t_sq.ctr_add(torch.as_tensor(ctr), t_pairs), want, ("pairs", seed))
    eq(t_ph.ctr_add_ref(torch.as_tensor(ctr), t_pairs), want,
       ("plain pairs", seed))
    # the one-pair form, bool value
    col, v = pairs[0]
    eq(t_sq.ctr_add(torch.as_tensor(ctr), col, torch.as_tensor(v)),
       j_sq.ctr_add(jnp.asarray(ctr), col, jnp.asarray(v).astype(jnp.int32)),
       ("one bool pair", seed))


def test_multi_pair_ctr_add_checks_every_pair():
    t_reg.reset_launches()
    ctr = torch.zeros((W, NC), dtype=torch.int32)
    ok = torch.ones(W, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, [(c % NC, ok) for c in range(17)])
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, [])
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, [(0, ok), (1, torch.zeros(W, dtype=torch.int64))])
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr, [(0, ok), (1, torch.zeros(W + 1, dtype=torch.bool))])
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr, [(0, torch.zeros((W, 2), dtype=torch.int32)[:, 0])])
    with pytest.raises(IndexError):
        t_sq.ctr_add(ctr, [(0, ok), (NC, ok)])
    with pytest.raises(IndexError):
        t_sq.ctr_add(ctr, [(-1, ok)])
    out = t_sq.ctr_add(ctr, [(c % NC, ok) for c in range(16)])
    assert int(out.sum()) == 16 * W and int(ctr.sum()) == 0
    assert all(k.launches == 0 for k in t_reg.KERNELS.values())


def _c_struct(name: str) -> type:
    """The ctypes mirror of ``struct <name>`` in ``csrc/sched_queue.cu``,
    read from the source: a pointer field is a ``c_void_p``, an ``int`` a
    ``c_int``, in the source's order."""
    src = t_sq.SOURCE.read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for decl in body.split(";")[:-1]:
        field = decl.split()[-1]
        ptr = "*" in decl
        fields.append((field.lstrip("*"),
                       ctypes.c_void_p if ptr else ctypes.c_int))
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def test_push_and_pop_records_pack_as_the_kernel_reads_them():
    """Each wrapper packs its arguments in one ``struct.pack``; the bytes
    are those of the C record (``PushArgs``, ``PopArgs``, read from the
    source) built field by field from the same tensors, so every pointer
    lands in the field the kernel reads it from, n_active's both ways."""
    rs = np.random.default_rng(5)
    q = tq(queues(rs))
    lanes = {k: torch.as_tensor(rs.integers(0, W, W).astype(np.int32))
             for k in ("producer", "consumer", "task", "tsv", "rot")}
    mask, ok = torch.ones(W, dtype=torch.bool), torch.ones(W, dtype=torch.bool)
    leaves = {k: getattr(q, k).data_ptr() for k in q._fields}
    ptr = {k: v.data_ptr() for k, v in lanes.items()}
    push_args = _c_struct("PushArgs")
    want = push_args(**leaves, **{k: ptr[k] for k in
                                  ("producer", "consumer", "task", "tsv")},
                     mask=mask.data_ptr(), ok=ok.data_ptr(), W=W, Q=Q)
    got = t_sq._push_record(q, lanes["producer"], lanes["consumer"],
                            lanes["task"], lanes["tsv"], mask, ok, W, Q)
    assert ctypes.sizeof(push_args) == t_sq._PUSH.size
    assert got == bytes(want)
    pop_args = _c_struct("PopArgs")
    assert ctypes.sizeof(pop_args) == t_sq._POP.size
    outs = t_sq._pop_outputs(lanes["rot"], mask)
    out_ptrs = dict(zip(("task_out", "ts_out", "src_out", "found_out",
                         "checked_out"), (t.data_ptr() for t in outs)))
    na = torch.tensor(W - 2, dtype=torch.int32)
    for n_active, na_ptr, na_val in ((na, na.data_ptr(), 0), (None, 0, W)):
        want = pop_args(**leaves, rot=ptr["rot"], mask=mask.data_ptr(),
                        n_active_ptr=na_ptr, **out_ptrs, W=W, Q=Q,
                        n_active=na_val)
        got = t_sq._pop_record(q, lanes["rot"], mask, n_active, outs, W, Q)
        assert got == bytes(want), n_active


def _byte_ranges(ts):
    return sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                  for t in ts)


def test_pop_outputs_keep_their_dtypes_and_share_no_memory():
    """The kernel's five outputs (``_pop_outputs``, what the card's path
    hands back) and the CPU path's are (W,) int32, int32, int32, bool and
    int32 tensors, contiguous, and no two share a byte."""
    for w in WIDTHS:
        rot = torch.zeros(w, dtype=torch.int32)
        mask = torch.ones(w, dtype=torch.bool)
        rs = np.random.default_rng(w)
        cpu = t_sq.pop_first(tq(queues(rs, w)), rot, mask)[1:]
        for outs in (t_sq._pop_outputs(rot, mask), cpu):
            assert [(t.dtype, tuple(t.shape)) for t in outs] == \
                [(torch.int32, (w,))] * 3 + [(torch.bool, (w,)),
                                             (torch.int32, (w,))]
            assert all(t.is_contiguous() for t in outs)
            ranges = _byte_ranges(outs)
            assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def test_pop_first_refuses_a_width_past_its_scan_key():
    """The kernel's scan key holds W up to ``POP_W_MAX``; a wider queue
    raises before anything is read (meta tensors: no memory)."""
    w = t_sq.POP_W_MAX + 1
    meta = t_xq.XQ(*(torch.empty(s, dtype=torch.int32, device="meta")
                     for s in ((w, w, 1), (w, w, 1), (w, w), (w, w))))
    lane = torch.zeros(w, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most"):
        t_sq.pop_first(meta, lane, lane.bool())
    assert "POP_W_MAX = 0xFFFF - 1;" in t_sq.SOURCE.read_text()


def test_push_refuses_a_width_past_its_block():
    """The kernel pushes with one block of W threads, W up to
    ``PUSH_W_MAX``; a wider queue raises before anything is read (meta
    tensors: no memory)."""
    w = t_sq.PUSH_W_MAX + 1
    meta = t_xq.XQ(*(torch.empty(s, dtype=torch.int32, device="meta")
                     for s in ((w, w, 1), (w, w, 1), (w, w), (w, w))))
    lane = torch.zeros(w, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most"):
        t_sq.push(meta, lane, lane, lane, lane, lane.bool())
    assert "PUSH_W_MAX = 1024;" in t_sq.SOURCE.read_text()
