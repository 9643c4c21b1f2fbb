"""The host side of batched serving, one implementation for the live
predictor (``serving.Predictor``) and a loaded export artifact
(``export.ExportedPredictor``). It imports nothing of the model code, so
that a loaded artifact runs without it.
"""

from __future__ import annotations

import numpy as np
import torch

from densereg_torch.utils.device import to_device
from densereg_torch.utils.profiling import span


def bucket_ladder(batch_buckets, max_batch: int) -> tuple:
    """The dispatch sizes, ascending: ``batch_buckets`` and ``max_batch``,
    which is always one, so that every chunk has a home."""
    buckets = sorted({int(v) for v in (batch_buckets or ())} | {max_batch})
    if buckets[0] < 1 or buckets[-1] > max_batch:
        raise ValueError(f"batch_buckets must lie in [1, max_batch="
                         f"{max_batch}]; got {buckets}")
    return tuple(buckets)


class HostLoop:
    """A subclass sets ``device``, ``max_batch``, ``batch_buckets``
    (:func:`bucket_ladder`), ``frame_hw``, ``num_joint`` and
    ``accepts_u16`` (uint16 frames cross the bus as they are), and defines
    ``_predict(frames, bbxs)``: device frames ``(bucket, H, W, 1)`` and
    boxes ``(bucket, 5)`` -> xyz ``(bucket, 3j)`` mm, without waiting."""

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        with span("densereg.feed"):
            return to_device(a, self.device)

    def warmup(self, with_u16: bool = True) -> None:
        """Run every (bucket, frame dtype) path once, so that no request
        pays for the first launch, the kernels' build or the capture of
        the int8 net's CUDA graph."""
        h, w = self.frame_hw
        bbx = np.asarray([[0, 0, h, w, 500.0]], np.float32)
        dtypes = ((np.float32, np.uint16) if with_u16 and self.accepts_u16
                  else (np.float32,))
        for bucket in self.batch_buckets:
            for dt in dtypes:
                self._dispatch(np.zeros((bucket, h, w, 1), dt),
                               np.repeat(bbx, bucket, 0)).cpu()

    def _dispatch(self, frames: np.ndarray, bbxs: np.ndarray) -> torch.Tensor:
        """Pad one chunk to the smallest bucket that fits and enqueue it;
        returns the device result, with bucket rows, without waiting."""
        with span("densereg.dispatch"):
            if frames.dtype != np.uint16 or not self.accepts_u16:
                frames = frames.astype(np.float32, copy=False)
            b = frames.shape[0]
            bucket = next(v for v in self.batch_buckets if v >= b)
            pad = bucket - b
            if pad:
                frames = np.concatenate([frames,
                                         np.repeat(frames[-1:], pad, 0)])
                bbxs = np.concatenate([bbxs, np.repeat(bbxs[-1:], pad, 0)])
            return self._predict(self._to_device(frames),
                                 self._to_device(np.asarray(bbxs,
                                                            np.float32)))

    def __call__(self, frames_mm: np.ndarray, bbxs: np.ndarray) -> np.ndarray:
        """frames_mm: (b, H, W) or (b, H, W, 1) raw depth, mm;
        bbxs: (b, 5) = (top, left, bottom, right, depth_threshold).
        Returns (b, 3j) xyz mm.

        Requests larger than ``max_batch`` run as a double-buffered chunk
        pipeline: chunk k+1 is padded and enqueued before chunk k's result
        is fetched."""
        with span("densereg.predict"):
            frames = np.asarray(frames_mm)
            if frames.ndim == 3:
                frames = frames[..., None]
            b = frames.shape[0]
            if b == 0:
                return np.zeros((0, 3 * self.num_joint), np.float32)
            out, pending = [], None
            for i in range(0, b, self.max_batch):
                chunk = frames[i:i + self.max_batch]
                dev = self._dispatch(chunk, bbxs[i:i + self.max_batch])
                if pending is not None:
                    out.append(_fetch(*pending))
                pending = (dev, len(chunk))
            out.append(_fetch(*pending))
            return out[0] if len(out) == 1 else np.concatenate(out)


def _fetch(dev: torch.Tensor, n: int) -> np.ndarray:
    """A dispatch's first ``n`` rows on the host: the host waits for the
    device here."""
    with span("densereg.fetch"):
        return dev[:n].cpu().numpy()
