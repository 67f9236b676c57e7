"""The port's encoder-decoder (whisper-tiny, reduced) against the reference
in float32, with the reference's weights carried across by
``convert.encdec_params_from_numpy``.

The reduced config's ``enc_frames`` (64) is raised to 100 in both packages:
longer than ``attn_chunk`` (64) and not a multiple of it, so the encoder's
non-causal self-attention and the decoder's cross-attention take the
blocked branch (the flash kernel's plain version) over a ragged end.  The
decoder's prompt (96 tokens) takes it too.  Bars: the sinusoidal positions
n x 2^-23 (XLA's exp and torch's differ by an ulp); ``encode`` 2e-5; the
prefill's logits, every layer's KV cache and the memory 2e-5; three greedy
decode steps from the prefill's caches with the memory (cross-attention
projected from it again each step), logits within 2e-5 and tokens equal;
and the reference's pure-LM decode (no memory: one zero frame) likewise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import encdec_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common, encdec  # noqa: E402
from repro_torch.training.step import make_serve_steps  # noqa: E402

TOL = 2e-5
FRAMES = 100  # > attn_chunk, not a multiple of it
PROMPT = 96


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, port cfg, reference params, port params, enc_input)."""
    cfg_j = dataclasses.replace(jconfigs.get_arch("whisper-tiny").reduced(), enc_frames=FRAMES)
    cfg = dataclasses.replace(configs.get_arch("whisper-tiny").reduced(), enc_frames=FRAMES)
    assert FRAMES > cfg.attn_chunk and FRAMES % cfg.attn_chunk
    params_j, _ = jmodels.build(cfg_j).init(jax.random.key(0))
    params = encdec_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    enc = np.random.default_rng(2).normal(size=(2, FRAMES, cfg.d_model)).astype(np.float32)
    return cfg_j, cfg, params_j, params, enc


def test_sinusoidal_positions_match():
    """XLA's float32 exp and torch's differ by one ulp on a few of the
    frequencies (<= 1, so <= 2^-24 apart), which position p multiplies into
    its argument: the bar is n positions times one ulp of 1."""
    for n, d in ((FRAMES, 128), (1_500, 384)):
        np.testing.assert_allclose(common.sinusoidal_positions(n, d).numpy(),
                                   np.asarray(jcommon.sinusoidal_positions(n, d)),
                                   rtol=0, atol=n * 2.0**-23)


def test_encode_matches(carried):
    cfg_j, cfg, params_j, params, enc = carried
    mem_j = jax.jit(lambda p, e: jencdec.encode(p, cfg_j, e))(params_j, jnp.asarray(enc))
    mem = encdec.encode(params, cfg, torch.as_tensor(enc))
    assert mem.shape == (2, FRAMES, cfg.d_model)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), rtol=0, atol=TOL)


def _pad(cache, length):
    return type(cache)(*(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, length - a.shape[1]))
                         for a in cache))


@pytest.mark.parametrize("with_memory", [True, False])
def test_prefill_and_decode_match(carried, with_memory):
    cfg_j, cfg, params_j, params, enc = carried
    api_j, api = jmodels.build(cfg_j), models.build(cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, PROMPT))
    prefill, _ = make_serve_steps(cfg, api)
    logits_j, caches_j, mem_j = jax.jit(api_j.prefill)(params_j, jnp.asarray(toks, jnp.int32),
                                                       jnp.asarray(enc))
    logits, caches, mem = prefill(params, {"tokens": torch.as_tensor(toks),
                                           "enc_input": torch.as_tensor(enc)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), rtol=0, atol=TOL)
    assert len(caches) == cfg.n_layers
    for layer, cache in enumerate(caches):
        for got, want in zip(cache, caches_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want[layer]), rtol=0, atol=TOL)
    total = PROMPT + 3
    caches_j = JKVCache(*(jnp.pad(a, [(0, 0), (0, 0), (0, total - PROMPT), (0, 0), (0, 0)])
                          for a in caches_j))
    caches = [_pad(c, total) for c in caches]
    memory_j, memory = (mem_j, mem) if with_memory else (None, None)
    step_j = jax.jit(lambda p, c, t, i, m: jencdec.encdec_decode_step(p, cfg_j, c, t, i, m))
    tok_j, tok = jnp.argmax(logits_j, -1).astype(jnp.int32), torch.argmax(logits, -1)
    for i in range(PROMPT, total):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
        logits_j, caches_j = step_j(params_j, caches_j, tok_j, jnp.asarray(i, jnp.int32),
                                    memory_j)
        logits, caches = api.decode_step(params, caches, tok, i, memory=memory)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0, atol=TOL,
                                   err_msg=f"decode step at {i}")
        tok_j, tok = jnp.argmax(logits_j, -1).astype(jnp.int32), torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))


def test_launcher_serves_whisper():
    """The reduced launcher with ``--arch whisper-tiny`` on the CPU: its own
    seeded weights (not the reference's), so two runs give the same greedy
    tokens of the requested shape."""
    argv = ["--arch", "whisper-tiny", "--reduced", "--requests", "2", "--prompt-len", "4",
            "--gen", "3", "--device", "cpu"]
    first = serve.run(serve.parse_args(argv))
    again = serve.run(serve.parse_args(argv))
    assert first.tokens.shape == (2, 3) and first.arch == "whisper-tiny-smoke"
    np.testing.assert_array_equal(first.tokens, again.tokens)


def test_build_accepts_whisper():
    api = models.build(configs.get_arch("whisper-tiny"))
    assert callable(api.loss)
    # the training loss is ported (it raised until the training slice)
    small = configs.get_arch("whisper-tiny").reduced()
    params = models.build(small).init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    frames = torch.zeros((1, 4, small.d_model))
    with torch.no_grad():
        loss, metrics = models.build(small).loss(params, toks, toks, frames)
    assert bool(torch.isfinite(loss)) and set(metrics) == {"xent"}
