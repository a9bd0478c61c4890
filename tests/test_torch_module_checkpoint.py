"""The port's module archives (`training/module_checkpoint.py`) and its
msgpack codec (`utils/flax_msgpack.py`) against the JAX package's
(`dlwpbench_tpu/training/module_checkpoint.py`) and flax's
`serialization`.

- a JAX archive loads into the port: the registry builds the port's model
  from the saved args (flax's `parent` and `name` dropped), and its rollout
  is within 1e-4 of JAX's on the same inputs (fp32, two frameworks'
  summation orders);
- a port archive loads in JAX with every parameter equal bit for bit;
- the codec's bytes equal flax's `serialization.to_bytes` on the same tree
  (its state dict), and it decodes flax's bytes to the same leaves;
- a bad format is refused.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu.models import unet as junet
from dlwpbench_tpu.training import module_checkpoint as jmc
from dlwpbench_tpu_torch.training import module_checkpoint as tmc
from dlwpbench_tpu_torch.utils import flax_msgpack

# (JAX class, its args, channels (Cc, Cp, Cq), grid)
MODELS = {
    "unet": (junet.UNet, dict(constant_channels=1, prescribed_channels=0, prognostic_channels=2,
                              hidden_channels=(4,), context_size=1), (1, 0, 2), (8, 16)),
    "swin": (jswin.SwinTransformer, dict(img_height=8, img_width=16, constant_channels=2,
                                         prescribed_channels=1, prognostic_channels=3,
                                         embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                                         use_flash_attention=False), (2, 1, 3), (8, 16)),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(channels, grid, seed=0, B=1, T=3):
    rng = np.random.default_rng(seed)
    out = []
    for lead, c in (((B, 1), channels[0]), ((B, T), channels[1]), ((B, T), channels[2])):
        out.append(rng.standard_normal((*lead, c, *grid)).astype(np.float32) if c else None)
    return out


def _jax_archive(name, tmp_path):
    cls, args, channels, grid = MODELS[name]
    model = cls(**args)
    arrays = _inputs(channels, grid)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *[None if a is None else jnp.asarray(a)
                                                           for a in arrays])
    path = str(tmp_path / f"{name}.mdlus.zip")
    jmc.save_module_checkpoint(path, model, params)
    return path, model, params, arrays


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_archive_loads_into_the_port(name, tmp_path):
    path, jmodel, params, arrays = _jax_archive(name, tmp_path)
    with zipfile.ZipFile(path) as z:
        assert {"parent", "name"} <= set(json.loads(z.read("metadata.json"))["args"])
    model, tree = tmc.load_module_checkpoint(path)
    assert type(model).__name__ == type(jmodel).__name__
    assert set(tree) == {"params"}
    want = np.asarray(jax.jit(jmodel.apply)(params, *[None if a is None else jnp.asarray(a)
                                                      for a in arrays]))
    with torch.no_grad():
        got = model.eval()(*[None if a is None else torch.from_numpy(a) for a in arrays]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_port_archive_loads_in_jax(name, tmp_path):
    path, _, params, _ = _jax_archive(name, tmp_path)
    model, _ = tmc.load_module_checkpoint(path)
    out = str(tmp_path / "port.mdlus.zip")
    tmc.save_module_checkpoint(out, model, MODELS[name][1])
    jmodel, jparams = jmc.load_module_checkpoint(out)
    assert type(jmodel).__name__ == type(model).__name__
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(flat_got) == len(flat_want)
    for path_, leaf in flat_want:
        got = np.asarray(flat_got[path_])
        assert got.dtype == np.float32 and np.array_equal(got, np.asarray(leaf)), path_


TREES = {
    "params": lambda rng: {"params": {"Dense_0": {"kernel": rng.standard_normal((3, 4)).astype(
        np.float32), "bias": np.zeros(4, np.float32)}, "LayerNorm_0": {"scale": np.ones(
            40, np.float32)}}},
    "scalars": lambda rng: {"step": 3, "neg": -5, "big": 2**40, "small": -2**33, "rate": 1.25,
                            "f32": np.float32(2.5), "i64": np.int64(-7), "c": 1 + 2j,
                            "none": None, "flag": True, "name": "x" * 40},
    "sizes": lambda rng: {**{f"k{i}": rng.standard_normal(i).astype(np.float64)
                             for i in range(20)},
                          "wide": rng.integers(0, 9, (70, 70)).astype(np.int16),
                          "empty": np.zeros((0, 3), np.float32), "mask": np.array([True, False]),
                          "list": list(range(20)), "bin": b"\x00\x01" * 200},
}


@pytest.mark.parametrize("tree", list(TREES))
def test_codec_bytes_equal_flax(tree):
    t = TREES[tree](np.random.default_rng(len(tree)))
    want = serialization.to_bytes(t)
    # to_bytes serialises the state dict, in which flax's lists become maps
    # keyed "0", "1", ...; a parameter tree is its own state dict
    assert flax_msgpack.packb(serialization.to_state_dict(t)) == want
    if tree == "params":
        assert flax_msgpack.packb(t) == want
    got = flax_msgpack.unpackb(want)
    ref = serialization.msgpack_restore(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        if isinstance(b, (np.ndarray, np.generic)):
            assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
        else:
            assert a == b


def test_codec_reads_bfloat16_as_float32():
    x = jnp.asarray([1.5, -2.0, 3.140625], jnp.bfloat16)
    got = flax_msgpack.unpackb(serialization.to_bytes({"w": np.asarray(x)}))["w"]
    assert got.dtype == np.float32 and np.array_equal(got, np.asarray(x, np.float32))


def test_bad_format_rejected(tmp_path):
    path = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("metadata.json", json.dumps({"format": "other"}))
        z.writestr("params.msgpack", b"")
    with pytest.raises(ValueError, match="unsupported"):
        tmc.load_module_checkpoint(path)
