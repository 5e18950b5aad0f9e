"""repro_torch's train step, checkpoint restart and ``launch.train``
against repro's, on the CPU.

The port's step is autograd through ``models.model.train_loss`` plus
``training.optimizer.apply``; repro's is ``jax.value_and_grad`` plus its
AdamW. Same converted weights, same ``TrainPipeline`` batches: losses
within 1e-4 over 15 steps (``tests/test_system.py``'s loop), microbatch
accumulation within its 5e-5, a crashed and restarted run equal to an
uninterrupted one at ``tests/test_fault_tolerance.py``'s bounds, and
``launch.train.main`` ending on repro's final loss. xLSTM's free-running
losses drift from repro's (ROADMAP C.11); its losses on repro's weights
hold.
"""
import shutil
from argparse import Namespace
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import TrainPipeline as JaxPipeline
from repro.launch import train as JTRAIN
from repro.models import model as JMDL
from repro.training import optimizer as JOPT
from repro.training.train import make_train_step as jax_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import TrainPipeline
from repro_torch.launch import train as TRAIN
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import checkpoint as CK
from repro_torch.training import optimizer as OPT
from repro_torch.training.train import make_train_step, to_device


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs tiny shapes here: one intra-op thread a worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(arch="llama3.2-1b"):
    """(repro's config, the port's, repro's params, the port's copy) as
    ``tests/test_system.py::tiny`` builds them."""
    jcfg = replace(jax_reduced(jax_get_config(arch)), dtype="float32")
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    return jcfg, cfg


def weights(jcfg, cfg, seed):
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                      "cpu")


def leaves_close(a, b, atol):
    for x, y in zip(OPT.tree_leaves(a), OPT.tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-350m"])
def test_train_loss_decreases_like_repro(arch):
    """``tests/test_system.py::test_train_loss_decreases`` on both
    packages: 15 steps over 3 repeated batches. At every step the port's
    loss on repro's current weights is within 1e-4 of repro's, and the
    port's own run falls below 0.9 of its first loss. llama's free-running
    losses are within 1e-4 of repro's too; xLSTM's are not (ROADMAP C.11:
    AdamW turns gradients that are zero in exact arithmetic, the sLSTM
    input-gate bias's, into updates of rounding noise)."""
    jcfg, cfg = tiny(arch)
    jparams, params = weights(jcfg, cfg, 1)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=40)
    jstep = jax.jit(jax_train_step(jcfg, JMDL.DEFAULT_RT,
                                   JOPT.AdamWConfig(**kw)))
    step = make_train_step(cfg, MDL.DEFAULT_RT, OPT.AdamWConfig(**kw))
    jopt, opt = JOPT.init(jparams), OPT.init(params)
    jpipe = JaxPipeline(jcfg.vocab_size, seq_len=16, global_batch=4)
    pipe = TrainPipeline(cfg.vocab_size, seq_len=16, global_batch=4)
    want, got, forced = [], [], []
    for i in range(15):
        jb = {k: jnp.asarray(v) for k, v in jpipe.batch(i % 3).items()}
        batch = to_device(pipe.batch(i % 3), "cpu")
        with torch.no_grad():
            forced.append(float(MDL.train_loss(cfg, params_from_numpy(
                cfg, jax.tree.map(np.asarray, jparams), "cpu"), batch)[0]))
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        params, opt, m = step(params, opt, batch)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(forced, want, rtol=1e-4)
    if arch == "llama3.2-1b":
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(got).all() and got[-1] < got[0] * 0.9, got
    assert int(opt["step"]) == 15


def test_train_microbatch_accumulation_matches_full_batch():
    """``tests/test_system.py``'s check on the port: 2 microbatches
    against 1, params within 5e-5; a batch that is left untouched."""
    jcfg, cfg = tiny()
    _, params = weights(jcfg, cfg, 2)
    ocfg = OPT.AdamWConfig(lr=1e-3, clip_norm=1e9, weight_decay=0.0)
    pipe = TrainPipeline(cfg.vocab_size, seq_len=8, global_batch=4)
    batch = to_device(pipe.batch(0), "cpu")
    before = [p.clone() for p in OPT.tree_leaves(params)]
    outs = []
    for mb in (1, 2):
        step = make_train_step(cfg, MDL.DEFAULT_RT, ocfg, microbatches=mb)
        p2, _, m = step(params, OPT.init(params), batch)
        outs.append(p2)
        assert np.isfinite(float(m["loss"]))
    d = max(float((a - b).abs().max()) for a, b in
            zip(OPT.tree_leaves(outs[0]), OPT.tree_leaves(outs[1])))
    assert d < 5e-5, d
    for a, b in zip(before, OPT.tree_leaves(params)):
        assert torch.equal(a, b)            # the step is functional


def test_crash_restart_resumes_exactly(tmp_path):
    """``tests/test_fault_tolerance.py``'s contract on the port's
    checkpoint: 10 uninterrupted steps against 6 with a checkpoint every
    3, ``restore`` of the latest, and 4 more (losses rtol 1e-6, params
    atol 1e-6)."""
    jcfg, cfg = tiny()
    _, params0 = weights(jcfg, cfg, 0)
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step_fn = make_train_step(cfg, MDL.DEFAULT_RT, ocfg)
    pipe = TrainPipeline(cfg.vocab_size, seq_len=16, global_batch=4)

    def run(params, opt, start, stop, ckpt_every=None):
        losses = []
        for s in range(start, stop):
            params, opt, m = step_fn(params, opt,
                                     to_device(pipe.batch(s), "cpu"))
            losses.append(float(m["loss"]))
            if ckpt_every and (s + 1) % ckpt_every == 0:
                CK.save(tmp_path, s, {"params": params, "opt": opt})
        return params, opt, losses

    p_ref, _, loss_ref = run(params0, OPT.init(params0), 0, 10)
    run(params0, OPT.init(params0), 0, 6, ckpt_every=3)
    latest = CK.latest_step(tmp_path)
    assert latest == 5
    state = CK.restore(tmp_path, latest,
                       {"params": params0, "opt": OPT.init(params0)})
    assert int(state["opt"]["step"]) == 6
    assert state["opt"]["step"].dtype == torch.int32
    p_res, _, loss_res = run(state["params"], state["opt"], latest + 1, 10)
    np.testing.assert_allclose(loss_res, loss_ref[6:], rtol=1e-6)
    leaves_close(p_ref, p_res, 1e-6)
    step, tree = CK.restore_latest(tmp_path, {"params": params0})
    assert step == 5 and tree["params"]["layers"][0]["ln1"].shape == (64,)
    assert CK.restore_latest(tmp_path / "none", {}) == (None, None)


ARGV = ["--arch", "llama3.2-1b", "--steps", "6", "--seq", "16", "--batch",
        "2", "--d-model", "64", "--layers", "2", "--vocab", "256",
        "--lr", "3e-3", "--log-every", "1"]


def test_launch_train_matches_repro(tmp_path, capsys):
    """``launch.train.main`` at a tiny size on the CPU, from repro's
    initial weights: the same final loss as ``repro.launch.train.main``
    (1e-4); a restart from its checkpoints resumes and ends on the same
    loss."""
    want = JTRAIN.main(ARGV)
    ns = Namespace(d_model=64, layers=2, vocab=256)
    jcfg = JTRAIN.shrink(jax_get_config("llama3.2-1b"), ns)
    cfg = TRAIN.shrink(get_config("llama3.2-1b"), ns)
    _, params = weights(jcfg, cfg, 0)
    ck = str(tmp_path / "ck")
    argv = ARGV + ["--device", "cpu", "--ckpt-dir", ck, "--ckpt-every", "2"]
    got = TRAIN.main(argv, params=params)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    out = capsys.readouterr().out
    assert "[train] step     5 loss=" in out and "device=cpu" in out
    # crash after step 3: the newest checkpoint is step 3's
    shutil.rmtree(tmp_path / "ck" / "step_00000005")
    resumed = TRAIN.main(argv, params=params)
    assert "[train] restored step 3" in capsys.readouterr().out
    np.testing.assert_allclose(resumed, got, rtol=1e-6)


def test_launch_train_needs_a_card_unless_cpu():
    """Without ``--device cpu`` the driver asks for the card and raises
    when there is none (no silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TRAIN.main(ARGV)
