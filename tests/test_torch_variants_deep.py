"""The network modules at the deeper hourglasses of the larger inputs:
256 (depth 5) for all three, and 512 (depth 6) for ``um_v1_deconv``, whose
learned upsampling is the one part that the depth changes (all three at
512 take some 140 s under tier-1's six workers, past the 120 s a file
may take), s1/f8/J16, against Flax on the same seeded weights and one
hand-like crop, unfolded and folded. The other CPU tests hold depth 3 (64
input); ``chip_smoke.py`` holds depth 4 (128 input) on the card against
the CPU.

Tolerance: heads 1e-4 per element (PARITY.md, network row).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402

from densereg_tpu.config import NetConfig as JNetConfig  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402

from densereg_torch.config import NET_MODULES, NetConfig  # noqa: E402
from densereg_torch.models import fold_batch_norm, from_flax, init_variables  # noqa: E402
from densereg_torch.models.bridge import seeded_depth  # noqa: E402


CASES = [(256, m) for m in NET_MODULES] + [(512, "um_v1_deconv")]


@pytest.mark.parametrize("size,module", CASES,
                         ids=[f"{size}-{m}" for size, m in CASES])
def test_deep_hourglass_matches_flax(module, size):
    shape = dict(num_stack=1, num_fea=8, num_joint=16,
                 input_hw=(size, size), net_module=module)
    cfg = NetConfig(**shape)
    assert cfg.hourglass_depth == {256: 5, 512: 6}[size]
    variables = init_variables(cfg, seed=size)
    dms = seeded_depth(np.random.default_rng(size), 1, size, size)
    for fold in (False, True):
        tree = fold_batch_norm(variables) if fold else variables
        with torch.inference_mode():
            got = from_flax(tree, cfg)(torch.from_numpy(dms))
        jnet = JNet(JNetConfig(**shape, fold_bn=fold))
        want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(tree, dms)
        for key in ("hm", "hm3", "um"):
            g, w = got[key][0].numpy(), np.asarray(want[key][0])
            assert g.shape == w.shape == (1, size // 4, size // 4,
                                          16 * (3 if key == "um" else 1))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                       err_msg=f"{key} folded={fold}")
