"""The port's train step, its crash/resume drill and the SSD scan under grad.

Companion of ``tests/test_torch_train.py`` (which holds `LM.loss` and its
gradients against the JAX package): the port of ``tests/test_models.py:28``
(shapes and finite values of a train step); three `make_train_step` steps
on the reduced qwen2 in float32 against the JAX package's jitted step on
``tests/test_distributed.py:57``'s batch (parameters within 1e-4, loss
within 1e-5: the reference's bounds for a reassociated step); the
crash/resume drill of ``python -m repro_torch.launch.train --device cpu``
in subprocesses with ``tests/test_distributed.py:93``'s arguments (final
losses within 1e-6); the frontends' generator restarting at seed 1234 on
resume, pinned on the reduced whisper against the JAX package's own
``launch/train.py``; and `ssd_log` under grad on the CPU: differentiable,
bitwise autograd through the plain forward, no kernel counted (the
backward kernels are held on a card by ``tests/test_torch_ssd_bwd_gpu.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import specs as ref_specs
from repro.launch import train as ref_train
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import train as port_train
from repro_torch.launch.specs import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init, tree_leaves
from test_torch_train import ARCHS, Reference, batch_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL = ("--arch qwen2-1.5b --reduced --steps 12 --global-batch 4 --seq-len 32 --vocab 128 "
         "--ckpt-every 4 --log-every 100")


@pytest.fixture(scope="module")
def reference():
    return Reference()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_shapes_and_finite(arch):
    """tests/test_models.py:28 on the port: forward shapes, a finite loss and
    nonzero finite gradients."""
    cfg = registry.reduced_config(arch)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, 2, 12, seed=5).items()}
    logits, aux = m.forward(params, batch)
    assert logits.shape == (2, 12, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and aux.shape == ()
    paths, leaves = zip(*tree_leaves(params))
    for x in leaves:
        x.requires_grad_(True)
    loss = m.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert bool(torch.isfinite(loss))
    gn = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(gn) and gn > 0


def test_train_step_matches_reference_jitted_step(reference):
    """Three steps of make_train_step on the reduced qwen2 in float32 against
    the JAX package's jitted step (tests/test_distributed.py:57's batch)."""
    arch = "qwen2-1.5b"
    cfg = dataclasses.replace(ref_registry.reduced_config(arch), dtype="float32")
    ref_model = ref_build_model(cfg)
    rp = jax.tree.map(jnp.asarray, reference.param(arch))
    ro = ref_adamw.adamw_init(rp)
    tokens = np.zeros((8, 16), np.int32) + 3
    labels = np.ones((8, 16), np.int32)
    ref_step = jax.jit(ref_specs.make_train_step(ref_model))
    port_step = make_train_step(build_model(dataclasses.replace(registry.reduced_config(arch),
                                                                dtype="float32"), device="cpu"))
    params = convert.lm_params_from_reference(reference.param(arch))
    opt = adamw_init(params)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    for _ in range(3):
        rp, ro, rm = ref_step(rp, ro, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)})
        params, opt, m = port_step(params, opt, batch)
        assert abs(float(m["loss"]) - float(rm["loss"])) < 1e-5
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    want = dict(tree_leaves(jax.tree.map(np.asarray, rp)))
    d = max(float(np.abs(x.detach().numpy() - want[p]).max()) for p, x in tree_leaves(params))
    assert d < 1e-4, d
    assert int(opt["step"]) == 3 and all(x.grad is None for _, x in tree_leaves(params))


def test_ssd_log_under_grad_on_cpu_is_differentiable():
    gen = torch.Generator().manual_seed(8)
    la = (-torch.rand((2, 20, 3), generator=gen)).requires_grad_()
    Bm, Cm = (torch.randn((2, 20, 4), generator=gen, requires_grad=True) for _ in range(2))
    x = torch.randn((2, 20, 3, 5), generator=gen, requires_grad=True)
    before = ssd_ops.ssd_log.launches, ssd_ops.ssd_log_bwd.launches
    y, st = ssd_ops.ssd_log(la, Bm, Cm, x, 8)
    assert y.grad_fn is not None and ssd_ops.ssd_log.launches == before[0]
    got = torch.autograd.grad(y.square().sum() + st.sum(), (la, Bm, Cm, x))
    assert (ssd_ops.ssd_log.launches, ssd_ops.ssd_log_bwd.launches) == before
    y_r, st_r = ssd_ref.ssd_chunked_ref(la, Bm, Cm, x, 8)
    want = torch.autograd.grad(y_r.square().sum() + st_r.sum(), (la, Bm, Cm, x))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _run_port_train(argv, timeout=240):
    code = f"from repro_torch.launch.train import main; main({argv!r})"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_train_crash_resume_drill_on_cpu(tmp_path):
    """tests/test_distributed.py:93 on the port: uninterrupted, crashed after
    step 6, resumed from step 4's checkpoint; the final losses within 1e-6."""
    common = DRILL.split() + ["--device", "cpu"]
    clean = _run_port_train(common + ["--run-dir", str(tmp_path / "a")])
    assert clean.returncode == 0, clean.stdout + clean.stderr
    crashed = _run_port_train(common + ["--run-dir", str(tmp_path / "b"), "--crash-at-step",
                                        "6"])
    assert crashed.returncode != 0 and "injected crash after step 6" in crashed.stderr
    assert not os.path.exists(tmp_path / "b" / "result.json")
    resumed = _run_port_train(common + ["--run-dir", str(tmp_path / "b")])
    assert resumed.returncode == 0 and "[resume] from step 4" in resumed.stdout
    a = json.load(open(tmp_path / "a" / "result.json"))
    b = json.load(open(tmp_path / "b" / "result.json"))
    assert a["device"] == b["device"] == "cpu" and len(b["losses"]) == 8
    assert a["final_loss"] == pytest.approx(b["final_loss"], abs=1e-6)
    assert np.isfinite(a["losses"]).all() and a["losses"][4:] == pytest.approx(b["losses"],
                                                                               abs=1e-6)


def _drill_draws(module, main, monkeypatch, tmp_path):
    """The frontends' draws of an uninterrupted run and of a run crashed after
    step 6 and resumed, through ``main`` of ``module``: -> (draws, results)."""
    draws, real = {}, module.add_batch_extras

    def spy(batch, cfg, rng):
        out = real(batch, cfg, rng)
        draws[run].append(np.array(out["enc_frames"]))
        return out

    monkeypatch.setattr(module, "add_batch_extras", spy)
    args = (f"--arch whisper-large-v3 --reduced --steps 12 --global-batch 2 --seq-len 16 "
            f"--vocab 64 --ckpt-every 4 --log-every 100").split()
    args += ["--device", "cpu"] if module is port_train else []
    for run, extra in (("clean", []), ("crashed", ["--crash-at-step", "6"]), ("resumed", [])):
        draws[run] = []
        run_dir = str(tmp_path / module.__name__ / ("clean" if run == "clean" else "b"))
        if extra:
            with pytest.raises(SystemExit):
                main(args + ["--run-dir", run_dir] + extra)
        else:
            main(args + ["--run-dir", run_dir])
    results = {run: json.load(open(tmp_path / module.__name__ / run / "result.json"))
               for run in ("clean", "b")}
    return draws, results


def test_resumed_encdec_run_redraws_its_frames_as_the_reference_does(monkeypatch, tmp_path):
    """`launch/train.py`'s frontend generator restarts at seed 1234 on every
    start (the JAX package's ``train.py:108``): a resumed whisper run draws
    the uninterrupted run's first frames again at step 4, so its losses
    leave the uninterrupted run's.  The port keeps that: the same draws as
    the JAX package's ``launch/train.py``, bitwise, and in both the resumed
    run differs."""
    port, port_res = _drill_draws(port_train, port_train.main, monkeypatch, tmp_path)
    ref, ref_res = _drill_draws(ref_train, ref_train.main, monkeypatch, tmp_path)
    assert [len(port[r]) for r in ("clean", "crashed", "resumed")] == [12, 7, 8]
    for run in port:
        assert len(port[run]) == len(ref[run])
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(port[run],
                                                                                 ref[run]))
    assert np.array_equal(port["resumed"][0], port["clean"][0])       # the generator restarted
    assert not np.array_equal(port["resumed"][0], port["clean"][4])   # not step 4's frames
    for res in (port_res, ref_res):
        assert abs(res["clean"]["final_loss"] - res["b"]["final_loss"]) > 1e-6
