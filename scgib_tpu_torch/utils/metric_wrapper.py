"""NaN-aware metric wrapper for multi-task labels, NumPy: a copy of
``scgib_tpu/utils/metric_wrapper.py`` (the reference's ``MetricWrapper``,
MetricWrapper.py:6-111).  Four NaN policies: ``None`` (pass through), a
number (NaNs replaced by it), ``'ignore-flatten'`` (both flattened, NaN
positions dropped) and ``'ignore-mean-label'`` (per column over its
non-NaN rows, columns whose metric raises skipped, the mean of the rest).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np


class MetricWrapper:
    def __init__(self, metric: Callable,
                 target_nan_mask: Optional[Union[str, int, float]] = None,
                 **kwargs):
        self.metric = metric
        self.target_nan_mask = target_nan_mask
        self.kwargs = kwargs

    def __call__(self, preds, target):
        preds = np.asarray(preds)
        target = np.asarray(target, dtype=np.float64)
        if preds.ndim == 1:
            preds = preds[:, None]
        if target.ndim == 1:
            target = target[:, None]

        nans = np.isnan(target)
        mask = self.target_nan_mask
        if mask is None:
            return self.metric(preds, target, **self.kwargs)
        if isinstance(mask, (int, float)) and not isinstance(mask, bool):
            target = np.where(nans, float(mask), target)
            return self.metric(preds, target, **self.kwargs)
        if mask == "ignore-flatten":
            return self.metric(preds[~nans], target[~nans], **self.kwargs)
        if mask == "ignore-mean-label":
            vals = []
            for i in range(target.shape[-1]):
                keep = ~nans[:, i]
                try:
                    vals.append(float(self.metric(preds[keep, i],
                                                  target[keep, i],
                                                  **self.kwargs)))
                except Exception:
                    pass
            if not vals:
                return float("nan")
            arr = np.asarray(vals, dtype=np.float64)
            finite = ~np.isnan(arr)
            return float(arr[finite].sum() / max(finite.sum(), 1))
        raise ValueError(f"Invalid target_nan_mask {mask!r}")
