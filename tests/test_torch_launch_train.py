"""``python -m repro_torch.launch.train`` against the reference's
``launch/train.py``: the same step-keyed tokens, the tiny preset's
losses, final weights and the change the steps made to them, over a few
steps from the reference's initial weights (bridged into the port's
``init_weights``), and a relaunch over a checkpoint directory that
repeats the first run's later steps."""
import ast

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jtrain
from repro.models import lm as jlm
from repro.models.common import init_params as jinit

import repro_torch.launch.train as ttrain
from repro_torch.configs import get_arch
from repro_torch.models.common import _leaves, params_from_numpy

torch.set_num_threads(1)

ARGS = ["--steps", "3", "--batch", "2", "--seq", "16"]
# fp32 on both sides, XLA's jitted step against eager PyTorch: the sums
# of the same products in other orders (tests/test_torch_lm.py)
ATOL = 1e-4
# the steps' change to each leaf, p - p0, against the reference's, as
# ||dp - dp_ref||_2 / ||dp_ref||_2.  Three warmup steps move an element
# by at most 3e-4 x (0 + 0.05 + 0.1) = 4.5e-5, below ATOL, so the final
# weights alone would pass an AdamW that did nothing.  Elementwise the
# changes part by up to 5 % of the largest: fp32 rounds p to a few ulps
# of the change, and AdamW's first steps move an element whose gradient
# is rounding noise by a share of lr either way.  Measured on the CPU
# 5.4e-5 - 9.2e-4 over both archs' leaves; an AdamW without its weight
# decay, or with its lr 5 % off, lands past 2**-7.
DELTA_RTOL = 2 ** -7


def test_synthetic_batches_are_the_references():
    cfg = get_arch("smollm-360m").config
    for step in (0, 7):
        a = jtrain.synthetic_lm_batch(cfg, 3, 16, step)
        b = ttrain.synthetic_lm_batch(cfg, 3, 16, step, "cpu")
        for k in ("tokens", "labels"):
            assert np.array_equal(np.asarray(a[k]), b[k].numpy())


def _ref_losses(out: str) -> dict:
    return {e["step"]: e["loss"] for e in
            (ast.literal_eval(line) for line in out.splitlines()
             if line.startswith("{'step'"))}


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_tiny_preset_matches_the_reference(arch, capsys, monkeypatch):
    jparams, _ = jtrain.main(["--arch", arch] + ARGS)
    want = _ref_losses(capsys.readouterr().out)
    jcfg = jconfigs.get_arch(arch).smoke()[0]
    init = jax.tree.map(np.asarray,
                        jinit(jlm.param_specs(jcfg), jax.random.key(0)))
    monkeypatch.setattr(ttrain, "init_weights",
                        lambda cfg, device: params_from_numpy(init, device))
    (params, opt), log = ttrain.main(["--arch", arch, "--device", "cpu"]
                                     + ARGS)
    out = capsys.readouterr().out
    assert [e["step"] for e in log] == [0, 1, 2]
    assert set(want) == {0, 2}
    for s, loss in want.items():
        assert abs(log[s]["loss"] - loss) <= ATOL, (s, log[s], loss)
    assert f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}" in out
    ref = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    start = dict(_leaves(init))
    for path, t in _leaves(params):
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0, atol=ATOL,
                                   err_msg=str(path))
        p0 = np.asarray(start[path], np.float64)
        moved = t.numpy().astype(np.float64) - p0
        want = ref[path].astype(np.float64) - p0
        assert np.abs(want).max() > ATOL / 10, path     # the steps moved it
        assert np.linalg.norm(moved - want) <= \
            DELTA_RTOL * np.linalg.norm(want), path
    assert int(opt["adam"]["step"]) == 3


def test_a_relaunch_resumes_from_the_latest_checkpoint(tmp_path):
    """Six steps with a checkpoint every three; the last one removed, the
    same command again resumes at step 3 and its steps 3-5 repeat the
    first run's exactly (the same state, the same step-keyed batches)."""
    args = ["--arch", "qwen3-14b", "--steps", "6", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    (p1, _), first = ttrain.main(args)
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_3",
                                                           "step_6"]
    for f in (tmp_path / "step_6").iterdir():
        f.unlink()
    (tmp_path / "step_6").rmdir()
    (p2, _), second = ttrain.main(args)
    assert [e["step"] for e in second] == [3, 4, 5]
    assert [e["loss"] for e in second] == [e["loss"] for e in first[3:]]
    for (_, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        assert torch.equal(a, b)


def test_train_drives_lm_archs_only():
    with pytest.raises(SystemExit, match="LM archs"):
        ttrain.main(["--arch", "mind", "--device", "cpu"])
