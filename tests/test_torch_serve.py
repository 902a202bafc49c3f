"""The port's serving path (``repro_torch.data.pipeline`` and
``repro_torch.launch.serve``) against the JAX package's: synthetic batches
bitwise, and greedy generation with the JAX package's weights carried
across equal, id for id, to the JAX serving loop (``serve.main``: prefill,
argmax, then ``decode_step`` and argmax per token)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels import registry as t_reg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402


@pytest.mark.parametrize("arch", ("gemma2_2b", "yi_9b", "hubert_xlarge",
                                  "pixtral_12b"))
def test_batch_for_equals_jax_bitwise(arch):
    for smoke in (True, False):
        jcfg = (j_cb.smoke_config if smoke else j_cb.get)(arch)
        tcfg = (t_cb.smoke_config if smoke else t_cb.get)(arch)
        seq = 24 if smoke else 300
        for step, lo, hi, seed in ((0, None, None, 0), (7, 1, 3, 5)):
            got = t_pipe.batch_for(tcfg, step, 4, seq, lo=lo, hi=hi,
                                   seed=seed)
            want = j_pipe.batch_for(jcfg, step, 4, seq, lo=lo, hi=hi,
                                    seed=seed)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype, (arch, k)
                assert np.array_equal(got[k], want[k]), (arch, smoke, k)


def _jax_serve_loop(params, cfg, batch, gen):
    """The loop of the JAX ``serve.main``, without its mesh."""
    max_len = batch["tokens"].shape[1] + gen
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


@pytest.mark.parametrize("arch", ("gemma2_2b", "yi_9b"))
def test_generate_gives_the_jax_greedy_ids(arch):
    B, S, GEN = 4, 48, 16
    jcfg, tcfg = j_cb.smoke_config(arch), t_cb.smoke_config(arch)
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    tok = t_pipe.batch_for(tcfg, 0, B, S)["tokens"]
    want = _jax_serve_loop(jp, jcfg, {"tokens": jnp.asarray(tok)}, GEN)
    out = serve.generate(tp, tcfg, {"tokens": torch.as_tensor(tok)}, GEN)
    assert out.ids.dtype == torch.int32 and tuple(out.ids.shape) == (B, GEN)
    assert np.array_equal(out.ids.numpy(), want), (out.ids, want)
    assert tuple(out.prefill_logits.shape) == (B, tcfg.vocab)
    zero = dict.fromkeys(t_reg.KERNELS, 0)
    assert out.launches == {"prefill": zero, "decode": zero}   # CPU: twins


def test_generate_crosses_the_local_ring():
    """Prompt 24 + 16 tokens with the smoke window of 32: the local
    layers' ring wraps during decode; still the JAX ids.  The embeddings
    are scaled down so that greedy decoding does not just repeat the last
    token (the tied head at N(0, 1) x sqrt(d_model) does), and the ids
    vary."""
    jcfg, tcfg = j_cb.smoke_config("gemma2_2b"), t_cb.smoke_config(
        "gemma2_2b")
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(1))
    jp = dict(jp, embed=jp["embed"] * 0.02)
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    tok = t_pipe.batch_for(tcfg, 3, 2, 24)["tokens"]
    want = _jax_serve_loop(jp, jcfg, {"tokens": jnp.asarray(tok)}, 16)
    got = serve.generate(tp, tcfg, {"tokens": torch.as_tensor(tok)}, 16)
    assert len(np.unique(want)) > 10
    assert np.array_equal(got.ids.numpy(), want)


def test_main_serves_on_the_cpu(capsys):
    out = serve.main(["--arch", "gemma2_2b", "--smoke", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4", "--device", "cpu",
                      "--seed", "3"])
    assert tuple(out.ids.shape) == (2, 4)
    assert bool(torch.isfinite(out.prefill_logits).all())
    text = capsys.readouterr().out
    assert "prefill 2x16" in text and "tok/s" in text and "on cpu" in text
    again = serve.main(["--smoke", "--batch", "2", "--prompt-len", "16",
                        "--gen", "4", "--device", "cpu", "--seed", "3"])
    assert torch.equal(again.ids, out.ids)


def test_main_without_a_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])


def test_main_refuses_an_encoder_only_config():
    """hubert_xlarge does not decode: ``serve.main`` exits, as the JAX
    ``serve.main`` asserts, and ``prefill`` raises."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])
    cfg = t_cb.smoke_config("hubert_xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        t_tfm.prefill(None, cfg, {"frames": torch.zeros((1, 4, 32))}, 8)
