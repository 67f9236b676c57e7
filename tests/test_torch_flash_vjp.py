"""The port's blocked attention with a hand-written backward
(``models/flash_vjp.py``) against the reference's ``blocked_attention_mo``
(a ``jax.custom_vjp``), on the CPU in float32 from numpy-seeded inputs.

Forward: ``out`` and the rows' log-sum-exp (the port's plain blocked
forward, the CPU path of the custom function and the card's yardstick)
against the reference's ``_fwd_impl``; backward: ``dq``, ``dk``, ``dv`` by
autograd against ``jax.vjp`` with the same cotangent.  Bar: 2e-5 of each
tensor's largest magnitude (both sum float32 products in other orders).
Cases: causal and not, 1, 2 and 4 query heads per kv head, cross-attention
(Sq != Sk, both causal offsets), rows that see no key (causal Sq > Sk, the
reference's convention: their lse is the masked -1e30 and every key's p is
1 in the backward), and a ragged length whose chunk is not a power of two.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattention  # noqa: E402
from repro.models import flash_vjp as jflash_vjp  # noqa: E402
from repro_torch.kernels.flash_attention.ref import blocked_attention_ref  # noqa: E402
from repro_torch.models import attention, flash_vjp  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one CPU thread here: these small ops gain nothing from more
    (the file takes the same time alone), while other test files run beside
    it on the same cores, where a pool of spinning threads per process
    slowed it 7-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# B, Sq, Sk, H, KV, dh, causal, attn_chunk
CASES = {
    "causal-rep1": (2, 64, 64, 4, 4, 32, True, 16),
    "noncausal-rep2": (2, 64, 64, 4, 2, 32, False, 16),
    "causal-rep4": (1, 64, 64, 8, 2, 32, True, 32),
    "cross-noncausal": (2, 32, 96, 4, 2, 32, False, 16),
    "cross-causal-offset": (1, 32, 96, 4, 2, 64, True, 16),
    "blind-rows": (1, 48, 32, 4, 2, 32, True, 16),
    "ragged-chunk-15": (1, 60, 60, 4, 2, 32, True, 16),
}


def _close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= TOL, f"{name}: max |d| / max |ref| = {err:.3e} > {TOL}"


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_attention_mo_matches_the_reference(case):
    B, Sq, Sk, H, KV, dh, causal, chunk = CASES[case]
    qc, kc = attention._pick_chunk(Sq, chunk), attention._pick_chunk(Sk, chunk)
    assert (qc, kc) == (jattention._pick_chunk(Sq, chunk), jattention._pick_chunk(Sk, chunk))
    scale = dh**-0.5
    rng = np.random.default_rng(Sq * 1000 + Sk + H)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh)))
    g = rng.normal(size=(B, Sq, H, dh)).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda a, b, c: jflash_vjp.blocked_attention_mo(a, b, c, causal, scale, qc, kc),
        *map(jnp.asarray, (q, k, v)))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(g))
    _, lse_j = jflash_vjp._fwd_impl(*map(jnp.asarray, (q, k, v)), causal, scale, qc, kc)

    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_vjp.blocked_attention_mo(qt, kt, vt, causal, scale, qc, kc)
    out.backward(torch.as_tensor(g))
    _, lse = blocked_attention_ref(qt.detach(), kt.detach(), vt.detach(), causal, scale, qc, kc)
    if causal and Sq > Sk:  # the blind rows' lse is the masked value itself
        assert np.all(lse.numpy()[..., : Sq - Sk] == np.asarray(lse_j)[..., : Sq - Sk])
    for name, got, want in (("out", out.detach(), out_j), ("lse", lse, lse_j),
                            ("dq", qt.grad, dq_j), ("dk", kt.grad, dk_j),
                            ("dv", vt.grad, dv_j)):
        _close(name, got.numpy(), want)


def test_blocked_attention_mo_is_autograd_through_the_plain_scan():
    """Away from blind rows the hand-written backward is the gradient of the
    plain blocked scan (``_blocked_attention``, differentiated by autograd)."""
    B, S, H, KV, dh = 1, 64, 4, 2, 32
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(B, S, n, dh)).astype(np.float32),
                            requires_grad=True) for n in (H, KV, KV))
    g = torch.as_tensor(rng.normal(size=(B, S, H, dh)).astype(np.float32))
    flash_vjp.blocked_attention_mo(q, k, v, True, dh**-0.5, 16, 16).backward(g)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention._blocked_attention(q, k, v, True, 16).backward(g)
    for name, a, b in zip(("dq", "dk", "dv"), got, (q.grad, k.grad, v.grad)):
        _close(name, a.numpy(), b.numpy())
