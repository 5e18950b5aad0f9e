"""int8 weight-only quantization (``core/quant.py``) against repro's, on the
CPU: ``tests/test_quant.py``'s four checks on both packages, plus the
serving path (prefill and decode steps) on quantized weights.

``torch.round`` and ``jnp.round`` both round half to even, so the int8
``q`` of the same fp32 weight is bit-equal and the scales equal.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import quant as JQ
from repro.core.paged_kv import PoolSpec as JaxPoolSpec
from repro.models import model as JMDL
from repro.models.layers import dense as jax_dense
from repro_torch.configs import get_config, reduced
from repro_torch.core import quant as Q
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import dense


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    jcfg = replace(jax_reduced(jax_get_config(arch)), dtype="float32")
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        jcfg = replace(jcfg, capacity_factor=8.0)
        cfg = replace(cfg, capacity_factor=8.0)
    return jcfg, cfg


def test_roundtrip_error_bounded():
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 128))) * 0.05
    jq = JQ.quantize_tensor(jnp.asarray(w))
    qw = Q.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(qw["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(qw["s"].numpy(), np.asarray(jq["s"]))
    deq = Q.dequantize_tensor(qw, torch.float32)
    rel = float((deq - torch.from_numpy(w)).abs().max() / np.abs(w).max())
    assert rel < 1.0 / 127 + 1e-3
    assert qw["q"].dtype == torch.int8 and tuple(qw["s"].shape) == (1, 128)


def test_dense_qtensor_matches_dequantized():
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 64)))
    w = np.array(jax.random.normal(jax.random.PRNGKey(2), (64, 32))) * 0.1
    qw = Q.quantize_tensor(torch.from_numpy(w))
    y_q = dense(torch.from_numpy(x), qw)
    y_deq = dense(torch.from_numpy(x), Q.dequantize_tensor(qw, torch.float32))
    torch.testing.assert_close(y_q, y_deq, atol=1e-5, rtol=1e-5)
    want = jax_dense(jnp.asarray(x), JQ.quantize_tensor(jnp.asarray(w)))
    np.testing.assert_allclose(y_q.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b"])
def test_quantized_decode_close_to_fp(arch):
    """repro's bounds on the port (bytes below 0.65x, logits within 0.12
    of their spread, greedy agreement >= 0.75), and the port's quantized
    params and logits equal repro's."""
    jcfg, cfg = configs(arch)
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    jq = JQ.quantize_params(jparams, min_size=1)
    qparams = Q.quantize_params(params, min_size=1)
    assert Q.quantized_bytes(qparams) < 0.65 * Q.quantized_bytes(params)
    assert Q.quantized_bytes(qparams) == JQ.quantized_bytes(jq)
    conv = params_from_numpy(cfg, jax.tree.map(np.asarray, jq), "cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    walk(qparams, conv)
    B, S = 2, 8
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size)))
    with torch.no_grad():
        fp = MDL.forward(cfg, params, toks)[0].numpy()
        qq = MDL.forward(cfg, qparams, toks)[0].numpy()
    assert np.abs(qq - fp).max() < 0.12 * (fp.max() - fp.min())
    assert (fp.argmax(-1) == qq.argmax(-1)).mean() >= 0.75
    want = np.asarray(JMDL.forward(jcfg, jq, jnp.asarray(toks.numpy()))[0])
    np.testing.assert_allclose(qq, want, atol=1e-4, rtol=1e-4)


def test_quantize_params_skips_small_and_norms():
    _, cfg = configs("llama3.2-1b")
    params = MDL.init_params(cfg, 0, torch.float32, "cpu")
    qp = Q.quantize_params(params)   # default min_size keeps smoke weights

    def qtensors(node):
        if Q.is_qtensor(node):
            return 1
        if isinstance(node, dict):
            return sum(qtensors(v) for v in node.values())
        if isinstance(node, list):
            return sum(qtensors(v) for v in node)
        return 0
    assert qtensors(qp) == 0
    # the embed table is never quantized (gather path), whatever the size
    qp1 = Q.quantize_params(params, min_size=1)
    assert not Q.is_qtensor(qp1["embed"])
    assert Q.is_qtensor(qp1["layers"][0]["attn"]["wq"])
    assert not Q.is_qtensor(qp1["layers"][0]["ln1"])


def test_quantized_serving_steps_match_repro():
    """Prefill and four decode steps on int8 weights (every quantizable
    leaf): the port's logits equal repro's within 1e-4 and stay within
    repro's 0.12-of-spread bound of the fp32 model's."""
    from repro.kernels.ops import write_targets
    jcfg, cfg = configs("llama3.2-1b")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    jq = JQ.quantize_params(jparams, min_size=1)
    qp = Q.quantize_params(params, min_size=1)
    B, S, page, n_pages, maxp = 2, 8, 4, 12, 4
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    bt = rng.permutation(n_pages)[:B * maxp].reshape(B, maxp).astype(np.int32)
    geo = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head, maxp)
    jst = JMDL.init_decode_state(jcfg, JaxPoolSpec(*geo, dtype="float32"), B)
    sts = {k: MDL.init_decode_state(cfg, PoolSpec(*geo, dtype="float32"), B,
                                    device="cpu") for k in ("q", "fp")}
    jl, jst = JMDL.prefill(jcfg, jq, jst, jnp.asarray(toks[:, :S]),
                           jnp.asarray(bt))
    outs = {k: [] for k in sts}
    want = [np.asarray(jl)]
    with torch.no_grad():
        for k, p in (("q", qp), ("fp", params)):
            outs[k].append(MDL.prefill(cfg, p, sts[k],
                                       torch.from_numpy(toks[:, :S]),
                                       torch.from_numpy(bt))[0].numpy())
        for t in range(S, S + 4):
            ctx = np.full((B,), t + 1, np.int32)
            npage, noff = write_targets(jnp.asarray(bt), jnp.asarray(ctx),
                                        jnp.ones((B,), bool), page_size=page,
                                        n_pages=n_pages)
            jl, jst = JMDL.decode_step(jcfg, jq, jst, jnp.asarray(toks[:, t]),
                                       jnp.asarray(bt), jnp.asarray(ctx),
                                       npage, noff)
            want.append(np.asarray(jl))
            for k, p in (("q", qp), ("fp", params)):
                outs[k].append(MDL.decode_step(
                    cfg, p, sts[k], torch.from_numpy(toks[:, t]),
                    torch.from_numpy(bt), torch.from_numpy(ctx),
                    torch.from_numpy(np.array(npage)),
                    torch.from_numpy(np.array(noff)))[0].numpy())
    q, fp = np.stack(outs["q"]), np.stack(outs["fp"])
    np.testing.assert_allclose(q, np.stack(want), atol=1e-4, rtol=1e-4)
    assert np.abs(q - fp).max() < 0.12 * (fp.max() - fp.min())
