"""repro_torch's training forward, loss, grads, data and optimizer against
repro's, on the CPU.

Every assigned architecture at ``tests/test_models.py::build``'s reduced
widths, on repro's weights converted to the port's layout
(``models.convert.params_from_numpy``, which also carries repro's grads
across: they are trees of the params' shapes). ``forward`` logits within
1e-4, ``train_loss`` within 1e-5 relative, every grad leaf within 1e-4
of its largest magnitude; ``Runtime(remat=True)`` gives the same loss and
grads; a Runtime with kernels refuses to train. ``TrainPipeline`` is
bit-equal to repro's; ``optimizer.apply`` on the same numpy grads equals
repro's within 1e-6 over 5 steps.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.data.pipeline import TrainPipeline as JaxPipeline
from repro.models import model as JMDL
from repro.training import optimizer as JOPT
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import TrainPipeline
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optimizer as OPT
from repro_torch.training.train import make_train_step
from test_models import build, make_inputs

B, S = 2, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs tiny shapes here: one intra-op thread a worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(arch):
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=8.0)   # as test_models.build
    return cfg


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def case():
    """Per arch, built once: (jcfg, JAX's MoE aux, cfg, params, jbatch,
    batch, JAX logits, JAX loss, JAX grads in the port's layout)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = build(arch), port_config(arch)
            jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0),
                                       jnp.float32)
            params = params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                         jparams), "cpu")
            toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                      jcfg.vocab_size)
            kw = make_inputs(jcfg, B, S, S)
            jbatch = {"tokens": toks, "targets": jnp.roll(toks, -1, 1),
                      "mask": jnp.ones((B, S)).at[1, -2:].set(0), **kw}
            logits, jaux = JMDL.forward(jcfg, jparams, toks, **kw)
            (loss, _), grads = jax.value_and_grad(
                lambda p: JMDL.train_loss(jcfg, p, jbatch),
                has_aux=True)(jparams)
            cache[arch] = (jcfg, float(jaux), cfg, params, jbatch,
                           _t(jbatch), np.asarray(logits), float(loss),
                           params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                               grads),
                                             "cpu"))
        return cache[arch]
    return get


def port_grads(cfg, params, batch, rt=MDL.DEFAULT_RT):
    leaves = [p.detach().requires_grad_(True)
              for p in OPT.tree_leaves(params)]
    loss, _ = MDL.train_loss(cfg, OPT.tree_unflatten(params, leaves), batch,
                             rt=rt)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_and_loss_match_repro(case, arch):
    jcfg, jaux, cfg, params, _, batch, jlogits, jloss, _ = case(arch)
    extra = {k: v for k, v in batch.items()
             if k in ("positions", "extra_embeds", "frames")}
    with torch.no_grad():
        logits, aux = MDL.forward(cfg, params, batch["tokens"], **extra)
        loss, metrics = MDL.train_loss(cfg, params, batch)
    assert logits.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert float(metrics["tokens"]) == B * S - 2
    # the MoE's load-balancing term: moe_local(..., with_aux=True) summed
    # over the layers, as repro's moe_local returns it
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5)
    assert float(aux) > 0 if cfg.is_moe else float(aux) == 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_grads_match_repro(case, arch):
    """Every grad leaf within 1e-4 of its largest magnitude (MoE: the
    aux term's grads through the router included)."""
    _, _, cfg, params, _, batch, _, jloss, jgrads = case(arch)
    loss, grads = port_grads(cfg, params, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = OPT.tree_leaves(jgrads)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((w - g).abs().max()) <= 1e-4 * scale, \
            (arch, w.shape, float((w - g).abs().max()), scale)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "xlstm-350m", "whisper-small",
                                  "mixtral-8x22b"])
def test_remat_matches_no_remat(case, arch):
    """``Runtime(remat=True)`` recomputes each layer in backward: the same
    loss and grads as without it."""
    _, _, cfg, params, _, batch, _, _, _ = case(arch)
    loss0, g0 = port_grads(cfg, params, batch)
    loss1, g1 = port_grads(cfg, params, batch, MDL.Runtime(remat=True))
    assert loss0 == loss1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_train_loss_with_kernels_raises(case):
    """No kernel of the port has a backward: training with kernels enabled
    raises (it never silently takes the plain route instead)."""
    _, _, cfg, params, _, batch, _, _, _ = case("llama3.2-1b")
    for kc in (KernelConfig(), KernelConfig(use_kernels=True)):
        rt = MDL.Runtime(kernels=kc)
        with pytest.raises(ValueError, match="no backward"):
            MDL.train_loss(cfg, params, batch, rt=rt)
        with pytest.raises(ValueError, match="no backward"):
            make_train_step(cfg, rt, OPT.AdamWConfig())
        grad_params = OPT.tree_unflatten(
            params, [p.detach().requires_grad_(True)
                     for p in OPT.tree_leaves(params)])
        with pytest.raises(ValueError, match="no backward"):
            MDL.forward(cfg, grad_params, batch["tokens"], rt=rt)
    # the plain paths asked for explicitly train
    rt = MDL.Runtime(kernels=KernelConfig(use_kernels=False))
    make_train_step(cfg, rt, OPT.AdamWConfig())


def test_train_loss_chunks_match_whole():
    """``loss_chunk`` below S splits the cross-entropy into recomputed
    chunks: the same loss as one chunk; a chunk that does not divide S
    falls back to the whole sequence, as in repro."""
    cfg = port_config("llama3.2-1b")
    params = MDL.init_params(cfg, 0, torch.float32, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in TrainPipeline(cfg.vocab_size, 16, 2).batch(0).items()}
    whole, _ = port_grads(cfg, params, batch)
    for chunk in (4, 5, 16):
        with torch.no_grad():
            got, _ = MDL.train_loss(cfg, params, batch, loss_chunk=chunk)
        np.testing.assert_allclose(float(got), whole, rtol=1e-6)


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_train_pipeline_bit_equal(n_hosts):
    for host in range(n_hosts):
        ours = TrainPipeline(1000, 24, 8, n_hosts=n_hosts, host_id=host,
                             seed=5)
        ref = JaxPipeline(1000, 24, 8, n_hosts=n_hosts, host_id=host, seed=5)
        assert ours.host_batch == ref.host_batch
        for step in (0, 1, 17):
            a, b = ours.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_optimizer_apply_matches_repro():
    """Five AdamW steps on the same numpy grads: params, moments, the
    schedule's lr and the grad norm equal repro's within 1e-6. Warmup 2 of
    6 total steps covers warmup and cosine decay; the grads' norm is above
    ``clip_norm`` (clipping on); weight decay on matrices only, which for
    repro's stacked layers includes their [L, D] norm weights."""
    cfg = port_config("llama3.2-1b")
    jcfg = build("llama3.2-1b")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5,
                weight_decay=0.1)
    jstate, state = JOPT.init(jparams), OPT.init(params)
    rng = np.random.default_rng(0)
    for _ in range(5):
        ng = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * 0.01, jparams)
        jparams, jstate, jm = JOPT.apply(JOPT.AdamWConfig(**ocfg), jparams,
                                         jax.tree.map(jnp.asarray, ng),
                                         jstate)
        params, state, m = OPT.apply(OPT.AdamWConfig(**ocfg), params,
                                     params_from_numpy(cfg, ng, "cpu"),
                                     state)
        assert float(jm["grad_norm"]) > 0.5
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 5
    for ours, ref in ((params, jparams), (state["m"], jstate["m"]),
                      (state["v"], jstate["v"])):
        want = OPT.tree_leaves(params_from_numpy(
            cfg, jax.tree.map(np.asarray, ref), "cpu"))
        for a, b in zip(OPT.tree_leaves(ours), want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # decay follows repro's leaf rank: a layer's [D] norm weight stands for
    # a stacked [L, D] leaf (decayed), final_norm [D] is not decayed
    decays = dict(zip(map(id, OPT.tree_leaves(params)),
                      OPT._decays(params)))
    assert decays[id(params["layers"][0]["ln1"])]
    assert not decays[id(params["final_norm"])]
