"""Port parity: checkpoints, the fault-tolerance manager and the data
pipeline.  ``repro_torch``'s ``SyntheticPipeline`` batches bitwise
``repro``'s; a checkpoint written by either package restored by the other,
bitwise; the manifest's msgpack byte for byte ``msgpack.packb``'s; and
``tests/test_checkpoint_data.py``'s cases in the port."""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as r_ckpt
from repro.data.pipeline import SyntheticPipeline as RPipeline
from repro.models import Model as RModel
from repro.models import ModelConfig as RConfig
from repro.optim import adamw as r_adamw
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager, FaultToleranceConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.interop import (
    adamw_state_from_arrays,
    adamw_state_to_arrays,
    model_params_from_arrays,
    params_to_arrays,
)
from repro_torch.models import Model, ModelConfig
from repro_torch.optim import adamw as t_adamw

torch.set_num_threads(2)

R_CFG = RConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=128)
T_CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                    d_ff=64, vocab_size=128)
EMBEDS = {"embed_inputs": False}  # a family that takes precomputed embeddings


def _cfgs(embeds):
    import dataclasses

    if not embeds:
        return R_CFG, T_CFG
    return dataclasses.replace(R_CFG, **EMBEDS), dataclasses.replace(T_CFG, **EMBEDS)


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("host", [(1, 0), (2, 1)], ids=["one-host", "host-1-of-2"])
@pytest.mark.parametrize("embeds", [False, True], ids=["tokens", "embeds"])
def test_pipeline_batches_are_bitwise_the_reference(embeds, host):
    n_hosts, host_id = host
    r_cfg, t_cfg = _cfgs(embeds)
    r_pipe = RPipeline(r_cfg, batch=4, seq_len=16, seed=7, n_hosts=n_hosts, host_id=host_id)
    t_pipe = SyntheticPipeline(t_cfg, batch=4, seq_len=16, seed=7, n_hosts=n_hosts,
                               host_id=host_id, device="cpu")
    for step in (0, 1, 42):
        want, got = r_pipe.batch_at(step), t_pipe.batch_at(step)
        dev = t_pipe.device_batch(step)
        assert got.keys() == want.keys() == dev.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
            assert dev[k].device.type == "cpu"
            np.testing.assert_array_equal(dev[k].numpy(), want[k])
    if embeds:
        assert (got["labels"][:, -1] == -1).all()
    else:
        assert got["tokens"].shape == (4 // n_hosts, 16)


def test_pipeline_host_sharding_and_restart():
    ps = [SyntheticPipeline(T_CFG, batch=8, seq_len=4, seed=1, n_hosts=2, host_id=h,
                            device="cpu") for h in (0, 1)]
    b0, b1 = ps[0].batch_at(0), ps[1].batch_at(0)
    assert b0["tokens"].shape[0] == 4
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    again = SyntheticPipeline(T_CFG, batch=8, seq_len=4, seed=1, n_hosts=2, host_id=0,
                              device="cpu")
    np.testing.assert_array_equal(again.batch_at(0)["tokens"], b0["tokens"])
    # labels are the next tokens
    b = ps[0].batch_at(3)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    with pytest.raises(ValueError, match="divide"):
        SyntheticPipeline(T_CFG, batch=3, seq_len=4, n_hosts=2, device="cpu")


def test_pipeline_prefetch_thread():
    p = SyntheticPipeline(T_CFG, batch=2, seq_len=8, seed=0, device="cpu").start(first_step=5)
    it = iter(p)
    a, b = next(it), next(it)
    p.stop()
    assert p._thread is not None and not p._thread.is_alive()
    assert isinstance(a["tokens"], torch.Tensor) and a["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(a["tokens"].numpy(), p.batch_at(5)["tokens"])
    np.testing.assert_array_equal(b["tokens"].numpy(), p.batch_at(6)["tokens"])


# --------------------------------------------------------------------------- #
# checkpoints across the packages
# --------------------------------------------------------------------------- #


def _train_state(seed):
    """The same training state in both packages: the port's
    ``{'params': Model, 'opt': {'adam': ..., 'ef': {}}}`` and the
    reference's tree, moments and step not at their initial values."""
    params = RModel(R_CFG).init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    adam = jax.tree.map(np.asarray, r_adamw.adamw_init(params, r_adamw.AdamWConfig()))
    rng = np.random.default_rng(seed)
    adam["mu"] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), adam["mu"])
    adam["nu"] = jax.tree.map(lambda a: rng.random(a.shape, dtype=np.float32), adam["nu"])
    adam["step"] = np.asarray(11 + seed, np.int32)
    model = model_params_from_arrays(T_CFG, tree, device="cpu")
    port = {"params": model,
            "opt": {"adam": adamw_state_from_arrays(adam, model, device="cpu"), "ef": {}}}
    ref = {"params": jax.tree.map(jnp.asarray, tree),
           "opt": {"adam": jax.tree.map(jnp.asarray, adam), "ef": {}}}
    return port, ref


def _port_arrays(state):
    return {"params": params_to_arrays(state["params"]),
            "opt": {"adam": adamw_state_to_arrays(state["opt"]["adam"]), "ef": {}}}


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(writer, tmp_path):
    """A training state saved by one package restores in the other,
    bitwise, and the two packages' files name the same leaves."""
    d = str(tmp_path)
    port_src, ref_src = _train_state(0)
    port_dst, ref_dst = _train_state(1)
    if writer == "port":
        path = ckpt.save_checkpoint(d, 12, port_src)
        restored, step = r_ckpt.restore_checkpoint(d, ref_dst)
        _assert_trees_equal(restored, ref_src)
        other = r_ckpt.save_checkpoint(str(tmp_path / "ref"), 12, ref_src)
    else:
        path = r_ckpt.save_checkpoint(d, 12, ref_src)
        restored, step = ckpt.restore_checkpoint(d, port_dst)
        assert restored is port_dst
        _assert_trees_equal(_port_arrays(restored), _port_arrays(port_src))
        other = ckpt.save_checkpoint(str(tmp_path / "port"), 12, port_src)
    assert step == 12
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        mine = msgpack.unpackb(f.read())
    with open(os.path.join(other, "manifest.msgpack"), "rb") as f:
        theirs = msgpack.unpackb(f.read())
    assert list(mine["leaves"]) == list(theirs["leaves"]) and mine == theirs


def _tree(seed=0):
    """tests/test_checkpoint_data.py's tree, as tensors."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 8, generator=g), "b": torch.zeros(8)},
        "opt": {"mu": torch.ones(8, 8), "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree()
    ckpt.save_checkpoint(d, 5, t)
    restored, step = ckpt.restore_checkpoint(d, _tree(seed=1))
    assert step == 5
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    assert int(restored["opt"]["step"]) == 7 and restored["opt"]["step"].dtype == torch.int32
    assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == [
        "_COMMITTED", "manifest.msgpack", "shard_0.npz"]


def test_latest_and_gc(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, _tree())
    assert ckpt.latest_step(d) == 4
    mgr = CheckpointManager(FaultToleranceConfig(directory=d, interval_steps=1, keep=2))
    mgr.maybe_save(5, _tree())
    assert ckpt.list_steps(d) == [4, 5]
    assert mgr.maybe_save(0, _tree()) is None  # step 0 is never due
    mgr2 = CheckpointManager(FaultToleranceConfig(directory=d, interval_steps=100, keep=2))
    assert mgr2.maybe_save(7, _tree()) is None
    mgr2.request_checkpoint()
    assert mgr2.maybe_save(7, _tree()).endswith("step_00000007")
    assert ckpt.list_steps(d) == [5, 7]


@pytest.mark.parametrize("writer", [ckpt, r_ckpt], ids=["port", "reference"])
def test_uncommitted_checkpoint_ignored(writer, tmp_path):
    d = str(tmp_path)
    tree = _tree() if writer is ckpt else {"w": jnp.zeros((4, 4))}
    writer.save_checkpoint(d, 1, tree)
    os.makedirs(os.path.join(d, "step_00000002"))  # a crashed, uncommitted step 2
    os.makedirs(os.path.join(d, "step_00000003.tmp"))
    assert ckpt.latest_step(d) == r_ckpt.latest_step(d) == 1


@pytest.mark.parametrize("writer", [ckpt, r_ckpt], ids=["port", "reference"])
def test_shape_mismatch_rejected(writer, tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.zeros(4, 4)} if writer is ckpt else {"w": jnp.zeros((4, 4))}
    writer.save_checkpoint(d, 1, tree)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, {"w": torch.zeros(5, 5)})
    with pytest.raises(KeyError, match="missing leaf v"):
        ckpt.restore_checkpoint(d, {"v": torch.zeros(4, 4)})


def test_stacked_leaf_shape_mismatch_rejected(tmp_path):
    """A model of another depth cannot restore a model's checkpoint."""
    import dataclasses

    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, {"params": Model(T_CFG, device="cpu")})
    deeper = Model(dataclasses.replace(T_CFG, n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="blocks/sub0"):
        ckpt.restore_checkpoint(d, {"params": deeper})


def test_manager_resume_or_init(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(FaultToleranceConfig(directory=d, interval_steps=1))
    state, start = mgr.resume_or_init(_tree)
    assert start == 0
    mgr.maybe_save(3, state)
    state2, start2 = mgr.resume_or_init(lambda: _tree(seed=2))
    assert start2 == 4
    assert torch.equal(state2["params"]["w"], state["params"]["w"])


def test_straggler_detection():
    mgr = CheckpointManager(FaultToleranceConfig(straggler_factor=2.0))
    for i in range(5):
        assert not mgr.observe_step(i, 1.0)
    assert mgr.observe_step(5, 3.0, {"why": "slow"})  # 3x the EWMA
    assert mgr.straggler_events == [
        {"step": 5, "duration_s": 3.0, "ewma_s": 1.0, "why": "slow"}]
    # the EWMA is not poisoned by the straggler
    assert not mgr.observe_step(6, 1.1)


# --------------------------------------------------------------------------- #
# the manifest's msgpack
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("value", [
    {"step": 5, "leaves": {"a/b": {"shape": [2, 3], "dtype": "float32", "file": "shard_0.npz"}}},
    {"s": "x" * 31, "t": "y" * 32, "u": "z" * 255, "v": "w" * 256, "w": "q" * 70000},
    {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
              -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]},
    {f"k{i}": list(range(i)) for i in range(40)},
    {"big": list(range(70000)), "empty": {}, "none": [], "unicode": "µs → ns"},
], ids=["manifest", "strings", "ints", "sizes", "long"])
def test_manifest_msgpack_is_msgpacks(value):
    packed = ckpt.packb(value)
    assert packed == msgpack.packb(value)
    assert ckpt.unpackb(packed) == msgpack.unpackb(packed) == value


def test_manifest_msgpack_refuses_what_it_cannot_read():
    with pytest.raises(TypeError):
        ckpt.packb({"x": 1.5})
    with pytest.raises(ValueError, match="subset"):
        ckpt.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(msgpack.packb(1) + b"\x00")


def test_adamw_state_checkpoint_in_the_port(tmp_path):
    """A bf16-moment state saved by the port (as f32, exactly) restores into
    bf16 moments."""
    model = Model(T_CFG, device="cpu")
    cfg = t_adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    state = t_adamw.adamw_init(model, cfg)
    for v in state["mu"].values():
        v.copy_(torch.randn(v.shape))
    ckpt.save_checkpoint(str(tmp_path), 3, {"adam": state})
    fresh = t_adamw.adamw_init(model, cfg)
    ckpt.restore_checkpoint(str(tmp_path), {"adam": fresh})
    for k, v in state["mu"].items():
        assert fresh["mu"][k].dtype == torch.bfloat16 and torch.equal(fresh["mu"][k], v)
