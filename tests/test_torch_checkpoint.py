"""bf16 checkpoints across the two packages (`checkpoint/ckpt.py`), on the
CPU. The tree {"w": bf16[2, 3], "b": f32[3]} is written by each package's
`save_checkpoint` and restored by the other's; what each direction gives is
pinned:
  - reference to port: `w` comes back as torch.bfloat16, bit for bit (the
    reference writes ml_dtypes' bf16, which npz stores as `V2` beside a
    manifest that says "bfloat16"); the reference itself cannot restore that
    checkpoint, and skips it as corrupt;
  - port to reference: `w` comes back as float32 holding the bf16 values
    exactly (the port writes bf16 as f32: numpy has no bf16 of its own).
A leaf that is truly corrupt (a `V2` that the manifest calls float32, a
shape that contradicts the manifest) is still skipped."""
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as rckpt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402

W = np.array([[0.0, 1.0 / 7, -2.5], [3.0e-3, 65504.0, -1.0e-30]], dtype=np.float32)
B = np.array([1.0, -2.0, 0.5], dtype=np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _save_reference(d, step=1):
    rckpt.save_checkpoint(d, step, {"w": jnp.asarray(W, jnp.bfloat16),
                                    "b": jnp.asarray(B)})


def _like():
    return {"w": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.float32)}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_a_reference_bf16_checkpoint_restores_in_the_port_as_bf16_bits(tmp_path, device):
    d = str(tmp_path)
    _save_reference(d)
    with open(os.path.join(d, "step_000000000001", "manifest.json")) as f:
        assert json.load(f)["dtypes"] == ["float32", "bfloat16"]   # b, w
    assert ckpt.latest_valid_step(d) == 1
    tree, meta = ckpt.restore_checkpoint(d, _like(), device=device)
    assert meta["step"] == 1
    w = tree["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
    assert w.device.type == "cpu" and w.shape == (2, 3)
    want = torch.from_numpy(W).to(torch.bfloat16)   # round to nearest even, as jnp does
    np.testing.assert_array_equal(_bits(w), _bits(want))
    np.testing.assert_array_equal(np.asarray(tree["b"]), B)
    # the reference's own reader compares "bfloat16" with the V2 it reads
    # back, and finds no valid checkpoint: that side is the JAX package's
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert rckpt.latest_valid_step(d) is None


def test_a_port_bf16_checkpoint_restores_in_the_reference_as_f32(tmp_path):
    d = str(tmp_path)
    w = torch.from_numpy(W).to(torch.bfloat16)
    ckpt.save_checkpoint(d, 2, {"w": w, "b": torch.from_numpy(B)})
    tree, meta = rckpt.restore_checkpoint(d, {"w": jnp.zeros((2, 3), jnp.bfloat16),
                                              "b": jnp.zeros(3)})
    assert meta["step"] == 2
    got = np.asarray(tree["w"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, w.float().numpy())   # bf16 values, exactly
    np.testing.assert_array_equal(np.asarray(tree["b"]), B)
    # and the port's own round trip gives f32 too, which the trainer casts
    # back to the state's bf16 (tests/test_torch_trainer.py)
    mine, _ = ckpt.restore_checkpoint(d, _like())
    assert mine["w"].dtype == np.float32


def _corrupt(path, edit):
    man = os.path.join(path, "manifest.json")
    with open(man) as f:
        m = json.load(f)
    edit(m)
    with open(man, "w") as f:
        json.dump(m, f)


@pytest.mark.parametrize("fault", ["v2_called_float32", "shape"])
def test_a_truly_corrupt_leaf_is_still_skipped(tmp_path, fault):
    """A `V2` leaf is bf16 only where the manifest says "bfloat16"; a shape
    against the manifest is corrupt as before. The newest valid checkpoint
    is restored in its place, and an explicit step raises."""
    d = str(tmp_path)
    _save_reference(d, step=1)
    _save_reference(d, step=2)
    i = 1  # the manifest lists b (a0) then w (a1)

    def edit(m):
        if fault == "v2_called_float32":
            m["dtypes"][i] = "float32"
        else:
            m["shapes"][i] = [3, 2]
    _corrupt(os.path.join(d, "step_000000000002"), edit)
    assert not ckpt.checkpoint_valid(os.path.join(d, "step_000000000002"))
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        assert ckpt.latest_valid_step(d) == 1
    with pytest.warns(RuntimeWarning):
        tree, meta = ckpt.restore_checkpoint(d, _like())
    assert meta["step"] == 1 and tree["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.restore_checkpoint(d, _like(), step=2)
