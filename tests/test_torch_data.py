"""The port's data layer against the JAX package's: the synthetic shards,
the shard readers, ``InputPipeline`` and ``TestPipeline``.

The port keeps its own copies of the numpy-only modules
(``densereg_torch/data/base.py``, ``synthetic.py``); one npz shard format
feeds both packages.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_tpu.data import base as jbase  # noqa: E402
from densereg_tpu.data import synthetic as jsynthetic  # noqa: E402
from densereg_tpu.data.pipeline import InputPipeline as JInputPipeline  # noqa: E402
from densereg_tpu.data.pipeline import TestPipeline as JTestPipeline  # noqa: E402

from densereg_torch.data import (  # noqa: E402
    InputPipeline,
    ShardReader,
    get_dataset,
)
from densereg_torch.data import TestPipeline as TorchTestPipeline  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402

HW = (32, 32)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Synthetic shards made by each package from the same seed: 2 shards
    of 7 frames (so batches cross shard boundaries)."""
    root = tmp_path_factory.mktemp("synth")
    ours = synthetic.make_spec("training", directory=str(root / "torch"),
                               num_shards=2, samples_per_shard=7, seed=3)
    theirs = jsynthetic.make_spec("training", directory=str(root / "jax"),
                                  num_shards=2, samples_per_shard=7, seed=3)
    return ours, theirs


def test_shards_equal_the_jax_packages(dirs):
    ours, theirs = dirs
    assert len(ours.filenames) == len(theirs.filenames) == 2
    for a, b in zip(ours.filenames, theirs.filenames):
        assert os.path.basename(a) == os.path.basename(b)
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
                assert za[k].dtype == zb[k].dtype
    assert ours.cfg == tuple(theirs.cfg) and ours.jnt_num == theirs.jnt_num
    assert ours.fixed_bg_threshold == theirs.fixed_bg_threshold


def test_readers_read_each_others_shards(dirs, tmp_path):
    ours, theirs = dirs
    for path in ours.filenames + theirs.filenames:
        r, jr = ShardReader(path), jbase.ShardReader(path)
        assert len(r) == len(jr) == 7 and not r.has_bbx
        for k in ("depth", "pose", "name"):
            np.testing.assert_array_equal(r[k], jr[k])
    # written with boxes by one package, read by the other
    from densereg_torch.data.base import ShardWriter

    rng = np.random.default_rng(0)
    depth = rng.integers(0, 900, (3, 4, 5)).astype(np.uint16)
    with ShardWriter(str(tmp_path / "a.npz")) as w:
        for i in range(3):
            w.add(depth[i], np.full(6, i, np.float32), f"f{i}",
                  np.arange(5, dtype=np.float32) + i)
    jr = jbase.ShardReader(str(tmp_path / "a.npz"))
    assert jr.has_bbx and list(jr["name"]) == ["f0", "f1", "f2"]
    np.testing.assert_array_equal(jr["depth"], depth)
    with jbase.ShardWriter(str(tmp_path / "b.npz")) as w:
        w.add(depth[0], np.zeros(6, np.float32), "g")
    assert ShardReader(str(tmp_path / "b")).__len__() == 1
    assert get_dataset("synthetic", "training", directory=os.path.dirname(
        os.path.dirname(ours.filenames[0])), num_shards=2,
        samples_per_shard=7, seed=3).filenames == ours.filenames
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("kinect", "training")


def test_input_pipeline_order_and_shapes(dirs):
    """Same seed, one producer: the JAX pipeline's batches, in its order
    (poses exactly; crops, cfgs and coms to the crop's tolerances), shaped
    (sub_batch, batch, ...); ``skip`` starts the same stream later."""
    ours, theirs = dirs
    pipe = InputPipeline(ours, 3, 2, HW, seed=5, device="cpu")
    jpipe = JInputPipeline(theirs, 3, 2, HW, seed=5)
    late = InputPipeline(ours, 3, 2, HW, seed=5, skip=2, device="cpu")
    try:
        got = [b for _, b in zip(range(4), pipe)]
        want = [b for _, b in zip(range(4), jpipe)]
        later = [b for _, b in zip(range(2), late)]
    finally:
        pipe.close()
        jpipe.close()
        late.close()
    for g, w in zip(got, want):
        assert g["dm"].shape == (2, 3, 32, 32, 1) and g["dm"].is_cpu
        assert g["pose"].shape == (2, 3, 48) and g["cfg"].shape == (2, 3, 6)
        assert g["com"].shape == (2, 3, 3)
        np.testing.assert_array_equal(g["pose"].numpy(), np.asarray(w["pose"]))
        np.testing.assert_allclose(g["dm"].numpy(), np.asarray(w["dm"]),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["cfg"].numpy(), np.asarray(w["cfg"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(g["com"].numpy(), np.asarray(w["com"]),
                                   atol=1e-3, rtol=0)
    for g, l in zip(got[2:], later):
        assert torch.equal(g["pose"], l["pose"])


def test_test_pipeline_pads_and_matches_jax(dirs):
    ours, theirs = dirs
    got = list(TorchTestPipeline(ours, 4, HW, device="cpu"))
    want = list(JTestPipeline(theirs, 4, HW))
    assert len(got) == len(want) == 4                  # 14 frames -> 4 x 4
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        for k in ("pose", "cfg"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-6)
        np.testing.assert_allclose(g["dm"].numpy(), np.asarray(w["dm"]),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["com"].numpy(), np.asarray(w["com"]),
                                   atol=1e-3, rtol=0)
    last = got[-1]
    assert last["name"][1:] == [last["name"][1]] * 3   # 2 real, 2 repeated
    assert torch.equal(last["dm"][2], last["dm"][1])
    assert [n for b in got for n in b["name"]][:14] == [
        str(n) for f in ours.filenames for n in np.load(f)["name"]]
