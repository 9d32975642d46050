"""Training checkpoints across the two packages, and the training CLI, on
the CPU at reduced size.

The files are the reference's: ``state-{step:06d}.npz`` of
``jax.tree_util.keystr`` names over ``(params, opt)`` with bf16 widened to
float32, and ``latest.json``. The JAX package's files resume in the port,
whose next step is held to the reference's next step (float32: the loss
within rtol 1e-6, mu within 1e-3 of its leaf's largest |mu| and nu within
2e-3, the weights within 2·lr an element, the bars of
``tests/test_torch_train.py`` past a first step); the port's files read
back in the JAX package bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.launch.train as rlaunch
import repro.training.optimizer as ropt
import repro.training.train as rtrain
import repro_torch.configs as tcfg
import repro_torch.training.optimizer as topt
import repro_torch.training.train as ttrain
from repro.data.tokens import synthetic_batch as ref_batch
from repro.models.transformer import init_params as ref_init
from repro_torch import convert
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import train as tlaunch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
B, S = 2, 16
MOMENT_BAR = 1e-3


def _cfgs(name, f32=False, **kw):
    out = []
    for reg, dt in ((rcfg, jnp.float32), (tcfg, torch.float32)):
        cfg = reg.get_config(name).reduced()
        if f32:
            cfg = dataclasses.replace(cfg, dtype=dt)
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _opt():
    kw = dict(lr=LR, warmup_steps=1, total_steps=30)
    return ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)


def _ref_train(rc, steps, seed=0, path=None):
    """The reference from ``seed`` over ``steps`` steps (batch of step s
    at step s), saved to ``path`` after them when given."""
    ocfg, _ = _opt()
    params = ref_init(rc, jax.random.key(seed))
    opt = rtrain.init_train_state(rc, params)
    step = jax.jit(rtrain.make_train_step(rc, ocfg))
    metrics = []
    for s in range(steps):
        params, opt, m = step(params, opt, ref_batch(rc, s, S, B))
        metrics.append(m)
    if path is not None:
        rlaunch.save_train_ckpt(path, steps, params, opt)
    return params, opt, metrics


def _port_model(tc, seed=0):
    rc = rcfg.get_config(tc.name.removesuffix("-smoke")).reduced()
    rc = dataclasses.replace(rc, dtype=jnp.float32 if tc.dtype == torch.float32
                             else rc.dtype, grad_compress=tc.grad_compress)
    return convert.lm_params_from_arrays(
        tc, jax.tree.map(np.asarray, ref_init(rc, jax.random.key(seed))),
        device="cpu")


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "minitron-4b",
                                  "whisper-large-v3"])
def test_port_resumes_jax_checkpoint_and_takes_step_3(name, tmp_path):
    """The JAX package trains 2 steps and saves; the port restores into a
    model from another seed and takes step 3; the reference takes its step
    3 from its own state. Step 3's loss, moments and weights agree."""
    rc, tc = _cfgs(name, f32=True)
    params, opt, _ = _ref_train(rc, 2, path=str(tmp_path))
    model = _port_model(tc, seed=9)
    topt_state = ttrain.init_train_state(tc, model)
    step, model, topt_state = tlaunch.restore_train_ckpt(str(tmp_path), model,
                                                         topt_state)
    assert step == 2 and int(topt_state["step"]) == 2
    restored = convert.lm_named_from_tree(tc, jax.tree.map(np.asarray, params))
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), restored[k], k)
    ocfg, tocfg = _opt()
    params, opt, rm = jax.jit(rtrain.make_train_step(rc, ocfg))(
        params, opt, ref_batch(rc, 2, S, B))
    model, topt_state, tm = ttrain.make_train_step(tc, tocfg)(
        model, topt_state, synthetic_batch(tc, 2, S, B, device="cpu"))
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-6)
    assert int(topt_state["step"]) == int(opt["step"]) == 3
    for m, bar in (("mu", MOMENT_BAR), ("nu", 2 * MOMENT_BAR)):
        ref = convert.lm_named_from_tree(tc, jax.tree.map(np.asarray, opt[m]))
        for k, v in topt_state[m].items():
            top = float(np.abs(ref[k]).max())
            assert float(np.abs(v.numpy() - ref[k]).max()) <= bar * top, (m, k)
    ref = convert.lm_named_from_tree(tc, jax.tree.map(np.asarray, params))
    for k, p in model.named_parameters():
        assert float(np.abs(p.detach().numpy() - ref[k]).max()) <= 2 * LR, k


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", ["hymba-1.5b", "minitron-4b"])
def test_port_checkpoint_reads_back_in_jax_bit_for_bit(name, compress,
                                                       tmp_path):
    """The port trains 2 bf16 steps (with the error buffer when
    compressing) and saves; ``repro.launch.train.restore_train_ckpt`` reads
    the file into its own template: the same names, and every weight,
    moment, error and the step with the port's bits."""
    rc, tc = _cfgs(name, grad_compress=compress)
    model = _port_model(tc)
    opt = ttrain.init_train_state(tc, model)
    _, ocfg = _opt()
    step = ttrain.make_train_step(tc, ocfg)
    for s in range(2):
        model, opt, _ = step(model, opt, synthetic_batch(tc, s, S, B,
                                                         device="cpu"))
    tlaunch.save_train_ckpt(str(tmp_path), 2, model, opt)
    tmpl_p = ref_init(rc, jax.random.key(5))
    tmpl_o = rtrain.init_train_state(rc, tmpl_p)
    with np.load(tmp_path / "state-000002.npz") as z:
        flat, _ = jax.tree_util.tree_flatten_with_path((tmpl_p, tmpl_o))
        assert sorted(z.files) == sorted(jax.tree_util.keystr(k)
                                         for k, _ in flat)
    n, params, ropt_state = rlaunch.restore_train_ckpt(str(tmp_path), tmpl_p,
                                                       tmpl_o)
    assert n == 2 and int(ropt_state["step"]) == 2
    got = convert.lm_named_from_tree(tc, jax.tree.map(np.asarray, params))
    for k, p in model.named_parameters():
        assert got[k].dtype.name == str(p.dtype).removeprefix("torch."), k
        np.testing.assert_array_equal(_f32(got[k]), p.detach().float().numpy(),
                                      err_msg=k)
    for m in ("mu", "nu") + (("err",) if compress else ()):
        got = convert.lm_named_from_tree(tc, jax.tree.map(np.asarray,
                                                          ropt_state[m]))
        for k, v in opt[m].items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=(m, k))


def test_port_checkpoint_round_trip_resumes_the_same_run(tmp_path):
    """Save after 2 steps, restore into a fresh model, take 2 more: the
    same bits as 4 steps without a break (bf16, compressed)."""
    _, tc = _cfgs("minitron-4b", grad_compress=True)
    _, ocfg = _opt()
    step = ttrain.make_train_step(tc, ocfg)

    def run(model, opt, steps):
        for s in steps:
            model, opt, m = step(model, opt, synthetic_batch(tc, s, S, B,
                                                             device="cpu"))
        return model, opt, m

    whole = _port_model(tc)
    whole, wopt, wm = run(whole, ttrain.init_train_state(tc, whole), range(4))
    first = _port_model(tc)
    first, fopt, _ = run(first, ttrain.init_train_state(tc, first), range(2))
    tlaunch.save_train_ckpt(str(tmp_path), 2, first, fopt)
    later = _port_model(tc, seed=3)
    lopt = ttrain.init_train_state(tc, later)
    n, later, lopt = tlaunch.restore_train_ckpt(str(tmp_path), later, lopt)
    later, lopt, lm = run(later, lopt, range(n, 4))
    assert torch.equal(wm["loss"], lm["loss"])
    assert all(torch.equal(a, b) for a, b in zip(whole.parameters(),
                                                 later.parameters()))
    for m in ("mu", "nu", "err"):
        assert all(torch.equal(wopt[m][k], lopt[m][k]) for k in wopt[m])
    assert int(lopt["step"]) == 4


def test_restore_refuses_another_config(tmp_path):
    _, tc = _cfgs("minitron-4b")
    model = _port_model(tc)
    tlaunch.save_train_ckpt(str(tmp_path), 0, model,
                            ttrain.init_train_state(tc, model))
    wide = dataclasses.replace(tc, d_ff=256)
    other = convert.lm_params_from_arrays(
        wide, jax.tree.map(np.asarray, ref_init(dataclasses.replace(
            rcfg.get_config("minitron-4b").reduced(), d_ff=256),
            jax.random.key(0))), device="cpu")
    with pytest.raises(ValueError, match="ffn"):
        tlaunch.restore_train_ckpt(str(tmp_path), other,
                                   ttrain.init_train_state(wide, other))
    squeezed = dataclasses.replace(tc, grad_compress=True)
    model = _port_model(squeezed)
    with pytest.raises(KeyError, match="err"):
        tlaunch.restore_train_ckpt(str(tmp_path), model,
                                   ttrain.init_train_state(squeezed, model))


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minitron-4b", "--reduced", "--batch", "2", "--seq", "16",
         "--device", "cpu", *args],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_train_cli_runs_checkpoints_and_resumes_on_the_cpu(tmp_path):
    """4 steps saving every 2, then a resume to 6 from the last file: the
    lines the reference prints, and the files it writes."""
    res = _cli("--steps", "4", "--ckpt-every", "2", "--ckpt-dir", "ck",
               cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[train] minitron-4b-smoke: ")
    assert "batch=2x16 on cpu" in lines[0]
    steps = [ln for ln in lines if ln.strip().startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 1, 2, 3]
    assert lines[-1].startswith("[train] done: 4 steps in ")
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "latest.json", "state-000002.npz", "state-000004.npz"]
    res = _cli("--steps", "6", "--resume", "--ckpt-dir", "ck", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "[train] resumed at step 4" in res.stdout
    assert "[train] done: 2 steps in " in res.stdout


def test_train_cli_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "minitron-4b", "--reduced"])


def test_train_state_from_arrays_carries_the_reference_state():
    """The reference's state after 2 compressed bf16 steps, carried in
    memory (``lm_params_from_arrays``, ``train_state_from_arrays``): every
    moment, error and the step with the reference's bits; and the weights
    carried back (``lm_arrays_from_params``) make the reference's tree with
    its bf16 bits."""
    rc, tc = _cfgs("minitron-4b", grad_compress=True)
    params, opt, _ = _ref_train(rc, 2)
    tree = jax.tree.map(np.asarray, (params, opt))
    model = convert.lm_params_from_arrays(tc, tree[0], device="cpu")
    state = convert.train_state_from_arrays(tc, tree[1], device="cpu")
    assert set(state) == {"mu", "nu", "err", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 2
    for m in ("mu", "nu", "err"):
        ref = convert.lm_named_from_tree(tc, tree[1][m])
        assert set(state[m]) == {k for k, _ in model.named_parameters()}
        for k, v in state[m].items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=(m, k))
    back = convert.lm_arrays_from_params(tc, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree[0])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree[0])):
        np.testing.assert_array_equal(a, _f32(b))
