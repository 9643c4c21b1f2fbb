from densereg_torch.eval.loop import make_infer_fn

__all__ = ["make_infer_fn"]
