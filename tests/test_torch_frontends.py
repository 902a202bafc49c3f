"""The port's hybrid and frontend families against the JAX package's, with
the JAX package's own weights carried across by ``params_from_numpy``:
hymba (parallel attention + SSM heads), pixtral (image patches prepended
to the text) and hubert (audio frames, encoder-only).

Logits and decode caches are held to 2e-4 (atol and rtol), the JAX
package's own tolerance between its forward and its decode
(``tests/test_models.py``); greedy ids and lengths exactly.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
FAMILIES = ("hymba_1_5b", "pixtral_12b", "hubert_xlarge")
DECODERS = ("hymba_1_5b", "pixtral_12b")
#: sha256 over (name, bytes) of every leaf of the seed-0 smoke
#: ``init_params``, taken before the frontend and SSM leaves existed: a
#: config with neither draws the same weights
PARENT_CHECKSUMS = {
    "gemma2_2b":
        "4af420a1bd701e2f2842a301dbe5517e5103a7d56a61871838a916e333fc6a24",
    "rwkv6_1_6b":
        "18c2b559861dff74a9a45700cba72e6273e88e25aed5463da646ad2bc7749307",
    "moonshot_v1_16b_a3b":
        "27d9148a0f6f507ae08f0eac32337985cb318dec2e1062fb875a86d26a69542c",
}


def npy(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def close(a, b, label="", tol=TOL):
    np.testing.assert_allclose(npy(a), npy(b), **tol, err_msg=str(label))


def models(arch, key=0):
    """(config for each package, JAX params, the port's params).  The
    embeddings are scaled down so that greedy decoding does not just repeat
    the last token (see ``tests/test_torch_serve.py``)."""
    jcfg, tcfg = j_cb.smoke_config(arch), t_cb.smoke_config(arch)
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(key))
    jp = dict(jp, embed=jp["embed"] * 0.02)
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def batches(cfg, B, S, step=0):
    """``batch_for``'s batch (bitwise the JAX package's) for each package."""
    b = t_pipe.batch_for(cfg, step, B, S)
    return ({k: torch.as_tensor(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def state_close(t_state, j_state, label):
    assert np.array_equal(t_state.length.numpy(), np.asarray(j_state.length))
    assert len(t_state.caches) == len(j_state.caches)
    for p, (tc, jc) in enumerate(zip(t_state.caches, j_state.caches)):
        assert sorted(tc) == sorted(jc), (label, p)
        for key in tc:
            assert tuple(tc[key].shape) == jc[key].shape, (label, p, key)
            assert str(tc[key].dtype).split(".")[-1] == jc[key].dtype.name
            close(tc[key], jc[key], (label, p, key))


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_map_one_to_one_onto_the_jax_tree(arch):
    """The SSM leaves (``ssm``, ``attn_ln``, ``ssm_ln``) and the frontend's
    ``proj`` included; ``init_params`` draws the same shapes and dtypes."""
    jcfg, tcfg, jp, tp = models(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    jpaths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): np.asarray(leaf)
              for path, leaf in flat}
    tparams = dict(tp.named_parameters())
    assert sorted(tparams) == sorted(jpaths)
    for name, leaf in jpaths.items():
        assert np.array_equal(tparams[name].numpy(), leaf), name
    drawn = t_tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {n: (tuple(p.shape), p.dtype) for n, p in
            drawn.named_parameters()} == {
        n: (tuple(p.shape), p.dtype) for n, p in tp.named_parameters()}
    if tcfg.frontend:
        assert tuple(tp["frontend"]["proj"].shape) == (tcfg.frontend_dim,
                                                       tcfg.d_model)
    if tcfg.parallel_ssm:
        assert {"ssm", "attn_ln", "ssm_ln"} <= set(tp["streams"][0].keys())


@pytest.mark.parametrize("arch", sorted(PARENT_CHECKSUMS))
def test_seed0_weights_of_the_other_families_are_unchanged(arch):
    cfg = t_cb.smoke_config(arch)
    p = t_tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    h = hashlib.sha256()
    for n, t in p.named_parameters():
        h.update(n.encode())
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PARENT_CHECKSUMS[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp = models(arch)
    tb, jb = batches(tcfg, 2, 40)
    got, aux = t_tfm.forward(tp, tcfg, tb)
    want, _ = j_tfm.forward(jp, jcfg, jb)
    # every position: pixtral's 8 patches and 32 text tokens, hubert's
    # 40 frames
    assert t_tfm.prompt_len(tcfg, tb) == 40
    assert tuple(got.shape) == (2, 40, tcfg.vocab)
    close(got, want, arch)
    assert sorted(aux) == sorted(j_tfm.AUX_KEYS)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill, then 3 decode steps: logits of every step, the greedy ids,
    ``length`` (the patches counted), and the decode state leaf for leaf,
    the SSM state and conv carry included."""
    jcfg, tcfg, jp, tp = models(arch)
    B, S, EXTRA = 2, 30, 3
    tb, jb = batches(tcfg, B, S)
    max_len = S + EXTRA
    t_last, t_state = t_tfm.prefill(tp, tcfg, tb, max_len)
    j_last, j_state = j_tfm.prefill(jp, jcfg, jb, max_len)
    close(t_last, j_last, "prefill")
    # the full sequence: the 8 patches of the smoke vision config are
    # inside the 30 positions batch_for makes
    assert t_state.length.tolist() == [S] * B
    state_close(t_state, j_state, "prefill")
    if tcfg.parallel_ssm:
        assert {"ssm_state", "ssm_conv"} <= set(t_state.caches[0])
    t_tok = torch.argmax(t_last, -1).to(torch.int32)
    j_tok = jnp.argmax(j_last, -1).astype(jnp.int32)
    for t in range(EXTRA):
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok)), t
        t_log, t_state = t_tfm.decode_step(tp, tcfg, t_state, t_tok)
        j_log, j_state = j_tfm.decode_step(jp, jcfg, j_state, j_tok)
        close(t_log, j_log, ("decode", t))
        t_tok = torch.argmax(t_log, -1).to(torch.int32)
        j_tok = jnp.argmax(j_log, -1).astype(jnp.int32)
    assert np.array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert t_state.length.tolist() == [S + EXTRA] * B
    state_close(t_state, j_state, "decode")


def test_pixtral_prefill_counts_the_patches():
    """A vision batch of S text tokens fills ``frontend_len + S`` positions
    (fault F3: the length was the text alone, so the first decoded token
    overwrote a patch slot)."""
    _, tcfg, _, tp = models("pixtral_12b")
    b = t_pipe.batch_for(tcfg, 0, 2, 20)
    assert b["tokens"].shape[1] == 20 - tcfg.frontend_len
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    assert t_tfm.prompt_len(tcfg, tb) == 20
    _, state = t_tfm.prefill(tp, tcfg, tb, 24)
    assert state.length.tolist() == [20, 20]
    # the full layer's cache: patches then text at slots 0..19, the rest
    # empty
    k = state.caches[0]["k"]
    assert k.shape[3] == 24
    assert bool(k[:, :, :, :20].abs().sum(-1).gt(0).all())
    assert not bool(k[:, :, :, 20:].any())


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_the_full_forward(arch):
    """Teacher-forced decode reproduces the port's own full forward, as the
    JAX package checks for itself (``tests/test_models.py``): the SSM
    state and conv carry cross the prefill-to-decode handoff."""
    _, tcfg, _, tp = models(arch)
    B, S, EXTRA = 1, 24, 5
    tb, _ = batches(tcfg, B, S + EXTRA)
    full, _ = t_tfm.forward(tp, tcfg, tb)
    n_text = tb["tokens"].shape[1]
    head = dict(tb, tokens=tb["tokens"][:, :n_text - EXTRA])
    _, state = t_tfm.prefill(tp, tcfg, head, S + EXTRA)
    for t in range(EXTRA):
        tok = tb["tokens"][:, n_text - EXTRA + t]
        logits, state = t_tfm.decode_step(tp, tcfg, state, tok)
        close(logits, full[:, S + t], t, tol=dict(atol=3e-4, rtol=3e-4))


@pytest.mark.parametrize("arch", DECODERS)
def test_init_decode_state_matches_jax(arch):
    jcfg, tcfg = j_cb.smoke_config(arch), t_cb.smoke_config(arch)
    state_close(t_tfm.init_decode_state(tcfg, 3, 20),
                j_tfm.init_decode_state(jcfg, 3, 20), arch)


def _jax_serve_loop(params, cfg, batch, max_len, gen):
    """The loop of the JAX ``serve.main``, without its mesh."""
    logits, state = jax.jit(
        lambda p, b: j_tfm.prefill(p, cfg, b, max_len))(params, batch)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    step = jax.jit(lambda p, s, t: j_tfm.decode_step(p, cfg, s, t))
    outs = [np.asarray(tok)]
    for _ in range(gen - 1):
        logits, state = step(params, state, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(tok))
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("arch", DECODERS)
def test_generate_gives_the_jax_greedy_ids(arch):
    """``serve.generate`` with the JAX weights: the JAX serving loop's ids,
    which sizes its caches ``prompt_len + gen`` with the patches counted
    in ``prompt_len`` (fault F2: the port's were 8 slots short here)."""
    B, S, GEN = 2, 24, 8
    jcfg, tcfg, jp, tp = models(arch, key=1)
    tb, jb = batches(tcfg, B, S, step=2)
    want = _jax_serve_loop(jp, jcfg, jb, S + GEN, GEN)
    got = serve.generate(tp, tcfg, tb, GEN)
    assert tuple(got.ids.shape) == (B, GEN)
    assert np.array_equal(got.ids.numpy(), want), (got.ids, want)


@pytest.mark.parametrize("arch", DECODERS)
def test_main_serves_the_full_sequence_on_the_cpu(arch, monkeypatch):
    """``serve.main --smoke --device cpu``: the caches hold the whole
    prompt (patches and text) and every new token, and ``length`` after
    the prefill is the whole prompt (faults F2 and F3)."""
    seen = {}
    prefill = t_tfm.prefill

    def spy(params, cfg, batch, max_len, *a, **kw):
        last, state = prefill(params, cfg, batch, max_len, *a, **kw)
        seen.update(max_len=max_len, length=state.length.tolist(),
                    slots=state.caches[0]["k"].shape[3])
        return last, state

    monkeypatch.setattr(t_tfm, "prefill", spy)
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "24", "--gen", "6", "--device", "cpu"])
    assert tuple(out.ids.shape) == (2, 6)
    assert bool(torch.isfinite(out.prefill_logits).all())
    # pattern position 0 is a full-attention layer in both configs
    assert seen == dict(max_len=30, length=[24, 24], slots=30)


def test_hubert_forward_reads_frames_and_no_tokens():
    """The audio frontend projects the frames (``frontend_dim`` wide) and
    has no token embedding; the encoder's logits cover every frame."""
    _, tcfg, _, tp = models("hubert_xlarge")
    tb, _ = batches(tcfg, 2, 16)
    assert sorted(tb) == ["frames", "targets"]
    logits, _ = t_tfm.forward(tp, tcfg, {"frames": tb["frames"]})
    assert tuple(logits.shape) == (2, 16, tcfg.vocab)
    assert t_tfm.prompt_len(tcfg, tb) == 16
    # the token embedding is not read (the tied head still is)
    tp.embed[:, :] = 0.0
    blind = t_tfm._embed_inputs(tp, tcfg, {"frames": tb["frames"]})
    want = tb["frames"] @ tp["frontend"]["proj"]
    assert torch.equal(blind, want)
