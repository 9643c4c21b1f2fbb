"""The yardstick's counts: the forward's operations against
``torch.utils.flop_counter`` on the reference at the configurations'
sizes, the training step's, and the decode's bytes against the bound the
port's kernel table states."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import counting
from reference import net


@pytest.mark.parametrize("name,gflop", [("nyu14-bf16-batch1024", 9.73),
                                        ("icvl16-f32-batch1024", 9.79)])
def test_forward_flops_match_flop_counter(name, gflop):
    _, _, cfg, _ = common.load_cell(name)
    params, stats = net.param_shapes(cfg)
    meta = {k: torch.empty(s, device="meta") for k, s in params.items()}
    meta.update({k: torch.empty(s, device="meta") for k, s in stats.items()})
    folded = net.fold(meta, meta)
    x = torch.empty((1, cfg["input_size"], cfg["input_size"], 1),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        net.forward(net.Ctx(folded, "eval"), cfg, x)
    assert counting.forward_flops(cfg) == counter.get_total_flops()
    assert round(counting.forward_flops(cfg) / 1e9, 2) == gflop


def test_train_flops_match_flop_counter():
    cfg = dict(common.load_cell("icvl16-f32-train40x5")[2], num_stack=1,
               num_fea=8, input_size=32)
    params, stats = net.param_shapes(cfg)
    p = {k: torch.randn(s, requires_grad=True) for k, s in params.items()}
    s = {k: torch.ones(v) for k, v in stats.items()}
    x = torch.randn(2, 32, 32, 1)
    with FlopCounterMode(display=False) as counter:
        out = net.forward(net.Ctx(p, "train", stats=s, dropout_rate=0.0),
                          cfg, x)
        sum(t.sum() for v in out.values() for t in v).backward()
    assert 2 * counting.train_flops(cfg) == counter.get_total_flops()


def test_decode_bytes_give_the_kernel_tables_bound():
    need = counting.decode_bytes(256, 16, 32)
    assert round(need / counting.PEAK_BYTES_PER_S * 1e3, 4) == 0.0104
