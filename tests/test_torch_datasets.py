"""The port's dataset readers against the JAX package's: ICVL, NYU
(training, and testing with its boxes), MSRA and BigHand.

Miniature source trees in the datasets' own on-disk formats (the layouts
of ``tests/test_converters_e2e.py``: ``labels.txt`` with uvd poses, MATLAB
``joint_data.mat``, packed and 16-bit PNGs, MSRA's ``.bin``) are converted
by each package's converter; the shards, the specs and the test
pipeline's crops must agree. The port's modules are copies of the JAX
package's numpy-only ones, so everything but the crops is exact; the crops
are held to ``tests/test_torch_data.py``'s tolerances.
"""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_tpu.data import base as jbase  # noqa: E402
from densereg_tpu.data import bighand as jbighand  # noqa: E402
from densereg_tpu.data import icvl as jicvl  # noqa: E402
from densereg_tpu.data import msra as jmsra  # noqa: E402
from densereg_tpu.data import native as jnative  # noqa: E402
from densereg_tpu.data import nyu as jnyu  # noqa: E402
from densereg_tpu.data import png16 as jpng16  # noqa: E402
from densereg_tpu.data.pipeline import TestPipeline as JTestPipeline  # noqa: E402

from densereg_torch.data import base, bighand, icvl, msra, native, nyu  # noqa: E402
from densereg_torch.data import png16, synthetic  # noqa: E402
from densereg_torch.data import TestPipeline as TorchTestPipeline  # noqa: E402
from densereg_torch.data.mixed import MixedPipeline  # noqa: E402
from tests.test_converters_e2e import (  # noqa: E402
    _make_bighand_source,
    _make_icvl_source,
    _make_msra_source,
    _make_nyu_source,
    _make_nyu_train_source,
)

HW = (32, 32)
# dataset -> (port module, JAX module, source builder, conversions as
# (subset, keyword arguments), subsets whose specs are compared, spec kw)
DATASETS = {
    "icvl": (icvl, jicvl,
             lambda root, rng: _make_icvl_source(root, rng, 24, 8),
             [("training", {}), ("testing", {})],
             ["training", "training_small", "validation", "testing"], {}),
    "nyu": (nyu, jnyu,
            lambda root, rng: (_make_nyu_source(root, rng, 10),
                               _make_nyu_train_source(root, rng, 4)),
            [("training", {}), ("testing", {})],
            ["training", "training_small", "validation", "testing"], {}),
    "msra": (msra, jmsra,
             lambda root, rng: _make_msra_source(root, rng, 1),
             [(None, dict(pid=0))], ["training", "testing"], dict(pid=0)),
    "bighand": (bighand, jbighand,
                lambda root, rng: _make_bighand_source(root, rng, 6, 5),
                [("training", {}), ("testing", {})],
                ["training", "training_small", "testing"], {}),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each dataset's source tree, converted by the port in ``torch/`` and
    by the JAX package in ``jax/`` (copies of one tree)."""
    out = {}
    for name, (mod, jmod, make, conversions, _, _) in DATASETS.items():
        root = tmp_path_factory.mktemp(name)
        make(str(root / "src"), np.random.default_rng(7))
        for side, m in (("torch", mod), ("jax", jmod)):
            shutil.copytree(root / "src", root / side)
            for subset, kw in conversions:
                args = {} if subset is None else {"subset": subset}
                m.convert(str(root / side), num_threads=2, **args, **kw)
        out[name] = root
    return out


def _shards(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".npz"))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_converters_write_the_same_shards(trees, name):
    root = trees[name]
    shards = _shards(root / "torch")
    assert shards and shards == _shards(root / "jax")
    frames = 0
    for rel in shards:
        with np.load(root / "torch" / rel) as a, np.load(root / "jax" / rel) as b:
            assert sorted(a.files) == sorted(b.files), rel
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (rel, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel} {k}")
            frames += len(a["name"])
    assert frames > 0


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_shards_read_equal_in_either_package(trees, name):
    root = trees[name]
    for rel in _shards(root / "torch"):
        for side in ("torch", "jax"):
            path = str(root / side / rel)
            ours, theirs = base.ShardReader(path), jbase.ShardReader(path)
            assert len(ours) == len(theirs) and ours.has_bbx == theirs.has_bbx
            for k in ("depth", "pose", "name") + (("bbx",) if ours.has_bbx
                                                   else ()):
                np.testing.assert_array_equal(ours[k], theirs[k])


def _spec_fields(spec, root):
    d = dataclasses.asdict(spec)
    d["cfg"] = tuple(spec.cfg)
    d["directory"] = os.path.relpath(spec.directory, root)
    d["filenames"] = [os.path.relpath(f, root) for f in spec.filenames]
    sel = d.pop("pose_select")
    d["pose_select"] = None if sel is None else np.asarray(sel).tolist()
    return d


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_specs_equal(trees, name):
    """Every field, the shard lists with the reference's stride duplicates
    included; ``get_dataset`` gives the same spec as ``make_spec``."""
    mod, jmod, _, _, subsets, kw = DATASETS[name]
    root = trees[name]
    for subset in subsets:
        ours = mod.make_spec(subset, directory=str(root / "torch"), **kw)
        theirs = jmod.make_spec(subset, directory=str(root / "jax"), **kw)
        assert _spec_fields(ours, root / "torch") == _spec_fields(
            theirs, root / "jax"), subset
        assert _spec_fields(base.get_dataset(
            name, subset, directory=str(root / "torch"), **kw),
            root / "torch") == _spec_fields(ours, root / "torch")
    if name != "bighand":
        assert len(set(ours.filenames)) < len(ours.filenames)  # duplicates


def test_nyu_box_crops_match_jax(trees):
    """NYU's testing subset crops from its stored boxes (``uses_bbx``):
    the port's test pipeline against the JAX one's, padded last batch
    included."""
    root = trees["nyu"]
    ours = nyu.make_spec("testing", directory=str(root / "torch"))
    theirs = jnyu.make_spec("testing", directory=str(root / "jax"))
    assert ours.uses_bbx and theirs.uses_bbx
    got = list(TorchTestPipeline(ours, 4, HW, device="cpu"))
    want = list(JTestPipeline(theirs, 4, HW))
    assert len(got) == len(want) == 3                  # 10 frames -> 3 x 4
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        assert g["pose"].shape == (4, 42)              # 14 of 36 joints
        np.testing.assert_array_equal(g["pose"].numpy(), np.asarray(w["pose"]))
        np.testing.assert_allclose(g["cfg"].numpy(), np.asarray(w["cfg"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(g["dm"].numpy(), np.asarray(w["dm"]),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["com"].numpy(), np.asarray(w["com"]),
                                   atol=1e-3, rtol=0)
    assert float(got[0]["dm"].abs().max()) > 0


def _jax_native_settled(monkeypatch, wait_s: float = 120.0) -> bool:
    """Whether the JAX package's codec loads, asked once its library is
    complete. Its loader builds the shared ``native/libdepthio.so`` in place
    and remembers a failed load for the life of the process, so a worker
    that opened the file while another was still writing it reports False
    whatever the tree holds. The port builds its own copy atomically: where
    that loads, the JAX one can be built too, so wait for it, clearing the
    JAX loader's remembered state before each try."""
    while True:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_build_failed", False)
        if jnative.available() or not native.available() or wait_s <= 0:
            return jnative.available()
        time.sleep(0.5)
        wait_s -= 0.5


def test_depth_codecs_match_jax(trees, monkeypatch):
    """The PNG decoders (16-bit and NYU's packed RGB, through the native
    codec where it builds, PIL otherwise) and MSRA's ``.bin`` reader."""
    assert native.available() == _jax_native_settled(monkeypatch)
    root = trees["nyu"] / "src" / "dataset" / "test"
    png = sorted(p for p in os.listdir(root) if p.endswith(".png"))[0]
    np.testing.assert_array_equal(
        png16.read_depth_png(str(root / png), nyu_packed=True),
        jpng16.read_depth_png(str(root / png), nyu_packed=True))
    root = trees["icvl"] / "src" / "Testing" / "Depth" / "test_seq_1"
    with open(root / "image_0000.png", "rb") as f:
        data = f.read()
    assert png16.png_dims(data) == jpng16.png_dims(data) == (240, 320)
    np.testing.assert_array_equal(png16.decode_png16(data),
                                  jpng16.decode_png16(data))
    path = str(trees["msra"] / "src" / "P0" / "1" / "000000_depth.bin")
    np.testing.assert_array_equal(png16.read_msra_bin(path),
                                  jpng16.read_msra_bin(path))


def test_mixed_pipeline(trees, tmp_path):
    """It refuses datasets of different joint counts, and interleaves
    others on the given device."""
    specs = [icvl.make_spec("training", directory=str(trees["icvl"] / "torch")),
             nyu.make_spec("training", directory=str(trees["nyu"] / "torch"))]
    with pytest.raises(ValueError, match="one joint count"):
        MixedPipeline(specs, 2, device="cpu")
    same = [synthetic.make_spec("training", directory=str(tmp_path / d),
                                num_shards=1, samples_per_shard=4, seed=s)
            for d, s in (("a", 0), ("b", 1))]
    pipe = MixedPipeline(same, 2, input_hw=HW, weights=[1, 3], device="cpu")
    try:
        assert pipe.weights.tolist() == [0.25, 0.75]
        for _, batch in zip(range(3), pipe):
            assert batch["dm"].shape == (1, 2, 32, 32, 1)
            assert batch["dm"].device.type == "cpu"
    finally:
        pipe.close()
