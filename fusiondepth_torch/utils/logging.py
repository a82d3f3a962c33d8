"""Experiment logging: stdout progress lines + JSONL scalars (+ TensorBoard
when TensorFlow is available) + alerting.

Replaces the reference's tensorboardX + wandb pair (trainer.py:176-178,
644-681) with dependency-light equivalents: scalars always land in
log/<model>/<mode>/metrics.jsonl; tf.summary mirrors them when importable.
Alerts (the reference pushes wandb.alert on training anomalies,
trainer.py:43,653 / refiner.py:487) become `MetricLogger.alert` records in
alerts.jsonl + stderr, with `add_watch` threshold/NaN triggers evaluated on
every log_scalars call.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def normalize_image(x):
    """Rescale an array to span [0, 1] for visualization (reference
    utils.py:16-22)."""
    import numpy as np

    x = np.asarray(x)
    ma, mi = float(x.max()), float(x.min())
    d = ma - mi if ma != mi else 1e5
    return (x - mi) / d


def sec_to_hm_str(t: float) -> str:
    t = int(t)
    s, t = t % 60, t // 60
    m, h = t % 60, t // 60
    return f"{h:02d}h{m:02d}m{s:02d}s"


class MetricLogger:
    def __init__(self, log_dir: str, mode: str, use_tb: bool = True):
        self.dir = os.path.join(log_dir, mode)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.alert_path = os.path.join(self.dir, "alerts.jsonl")
        self._watches = []  # (metric, op, threshold, title)
        self._tb = None
        if use_tb:
            try:
                import tensorflow as tf  # noqa: F401

                self._tb = tf.summary.create_file_writer(self.dir)
            except Exception:
                self._tb = None

    # ---- alerting (wandb.alert equivalent) ----

    def alert(self, title: str, text: str, level: str = "WARN") -> None:
        """Emit an alert record (alerts.jsonl + stderr) — the offline
        equivalent of wandb.alert (reference trainer.py:43,653)."""
        import sys

        rec = {"time": time.time(), "level": level, "title": title,
               "text": text}
        with open(self.alert_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"ALERT[{level}] {title}: {text}", file=sys.stderr, flush=True)

    def add_watch(self, metric: str, op: str, threshold: float = 0.0,
                  title: Optional[str] = None) -> None:
        """Alert whenever `metric` crosses a threshold on log_scalars.

        op: ">" / "<" (threshold comparisons) or "nan" (non-finite guard).
        """
        assert op in (">", "<", "nan"), op
        self._watches.append((metric, op, threshold,
                              title or f"{metric} {op} {threshold}"))

    def _check_watches(self, step: int, scalars: Dict[str, float]) -> None:
        import math

        for metric, op, threshold, title in self._watches:
            if metric not in scalars:
                continue
            v = float(scalars[metric])
            fired = (math.isnan(v) or math.isinf(v)) if op == "nan" else (
                v > threshold if op == ">" else v < threshold)
            if fired:
                self.alert(title, f"step {step}: {metric}={v}")

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self._check_watches(step, scalars)
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default():
                for k, v in scalars.items():
                    tf.summary.scalar(k, float(v), step=int(step))

    def log_image(self, step: int, name: str, image) -> None:
        """Log an HWC [0,1] image (TensorBoard when available, else a png
        next to the metrics) — the reference's TB image logging
        (trainer.py:644-681)."""
        import numpy as np

        img = np.clip(np.asarray(image), 0.0, 1.0)
        if img.ndim == 2:
            img = img[..., None]
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default():
                tf.summary.image(name, img[None], step=int(step))
        else:
            from PIL import Image

            arr = (img * 255).astype(np.uint8)
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            Image.fromarray(arr).save(os.path.join(
                self.dir, f"{name.replace('/', '_')}_{int(step)}.png"))

    def close(self) -> None:
        self._f.close()
