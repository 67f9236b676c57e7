"""The port's flash attention (its plain version, which ``ops`` runs for a
CPU tensor) against the reference's Pallas kernel in interpret mode and its
``attention_ref``, on the sweep of ``tests/test_kernels.py`` and at the
reference's own tolerances (2e-3 in float32, 3e-2 in bfloat16), plus causal
rows that see no key (Sq > Sk), which return the mean of V in all three.
The CUDA kernel itself is held to this plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 8).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Sq, Sk, H, KV, dh):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(B, Sq, H, dh)).astype(np.float32),
        rng.normal(size=(B, Sk, KV, dh)).astype(np.float32),
        rng.normal(size=(B, Sk, KV, dh)).astype(np.float32),
    )


def _both(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype``."""
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    tx = [torch.as_tensor(a).to(TORCH[dtype]) for a in arrays]
    return jx, tx


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "B,Sq,Sk,H,KV,dh",
    [
        (1, 128, 128, 2, 2, 64),
        (2, 256, 256, 4, 2, 64),  # GQA
        (1, 128, 256, 2, 1, 128),  # Sq < Sk + MQA
        (1, 128, 64, 4, 2, 64),  # Sq > Sk: causal rows 0..63 see no key
    ],
)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_reference(B, Sq, Sk, H, KV, dh, causal, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(B * Sq + H + Sk, B, Sq, Sk, H, KV, dh), dtype)
    reset_launch_counts()
    got = _f32(flash_attention(q, k, v, causal=causal))
    assert launch_counts()["flash_attention"] == 0  # the CPU runs the plain version
    tol = TOL[dtype]
    pallas = _f32(pallas_flash(jq, jk, jv, causal=causal, bq=64, bk=64))
    ref = _f32(jax_attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_that_see_no_key_return_the_mean_of_v(dtype):
    B, Sq, Sk, H, KV, dh = 2, 128, 64, 4, 2, 64
    arrays = _inputs(7, B, Sq, Sk, H, KV, dh)
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    got = _f32(flash_attention(q, k, v, causal=True))
    v32 = _f32(v)
    mean_v = np.repeat(v32.mean(axis=1), H // KV, axis=1)  # [B, H, dh]
    tol = TOL[dtype]
    blind = Sq - Sk  # causal row i sees keys j <= i + Sk - Sq
    np.testing.assert_allclose(
        got[:, :blind], np.broadcast_to(mean_v[:, None], got[:, :blind].shape), rtol=tol, atol=tol
    )
    pallas = _f32(pallas_flash(jq, jk, jv, causal=True, bq=64, bk=64))
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


def test_plain_version_is_exact_where_only_the_order_differs():
    """Float32 on the same values: the port's plain version and the
    reference's agree far inside the flash tolerance (only summation
    order and the softmax implementation differ)."""
    arrays = _inputs(3, 2, 96, 160, 4, 2, 32)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    got = attention_ref(q, k, v, causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_attention_ref(jq, jk, jv)), rtol=0, atol=2e-6)
