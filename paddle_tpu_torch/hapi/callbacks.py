"""Training callbacks of the fit loop (port of
paddle_tpu/hapi/callbacks.py): the ``Callback`` protocol (train, eval and
predict begin/end, batch and epoch hooks), ``CallbackList``,
``config_callbacks`` assembling the default list, and ``ProgBarLogger``,
``ModelCheckpoint``, ``LRScheduler``, ``EarlyStopping``,
``ReduceLROnPlateau``, ``MonitorCallback`` (into the port's ``monitor``)
and ``VisualDL`` (which needs the ``visualdl`` package).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
    "LRScheduler", "EarlyStopping", "ReduceLROnPlateau", "VisualDL",
    "MonitorCallback", "config_callbacks",
]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params: Dict):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    # eval
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    # predict
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb: Callback):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-step console logging (reference: ProgBarLogger)."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        self._seen = 0

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        self._seen += logs.get("batch_size", 0)
        if self.verbose and step % self.log_freq == 0:
            epochs = self.params.get("epochs")
            msg = f"Epoch {self._epoch + 1}/{epochs} step {step}"
            for k, v in logs.items():
                if k in ("batch_size",):
                    continue
                try:
                    msg += f" {k}: {float(v):.4f}"
                except (TypeError, ValueError):
                    pass
            print(msg)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = max(time.time() - self._t0, 1e-9)
            print(f"Epoch {epoch + 1}: {self._seen / dt:.1f} samples/sec")

    def on_eval_end(self, logs=None):
        if self.verbose and logs:
            print("Eval:", {k: v for k, v in logs.items()
                            if k != "batch_size"})


class ModelCheckpoint(Callback):
    """Periodic save (reference: ModelCheckpoint)."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/epoch_{epoch + 1}")

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(f"{self.save_dir}/final")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference: LRScheduler callback;
    by_step -> every batch, else every epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch or not by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference:
    EarlyStopping — monitor/mode/patience/min_delta/baseline)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        # baseline seeds best: runs must beat it before counting as improved
        self.best = baseline
        self.wait = 0
        self.stopped_epoch = 0

    def _improved(self, cur) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple, np.ndarray)):
            value = float(np.asarray(value).ravel()[0])
        if self._improved(value):
            self.best = value
            self.wait = 0
            save_dir = self.params.get("save_dir")
            if self.save_best_model and save_dir and self.model is not None:
                self.model.save(f"{save_dir}/best_model")
        else:
            self.wait += 1
            if self.wait >= self.patience:
                if self.model is not None:
                    self.model.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement "
                          f"for {self.wait} evals, stopping")


class ReduceLROnPlateau(Callback):
    """Multiply LR by ``factor`` when the monitored metric plateaus
    (reference: ReduceLROnPlateau callback)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple, np.ndarray)):
            value = float(np.asarray(value).ravel()[0])
        if self.cooldown_counter > 0:
            # hold the reduced LR: no improvement tracking during cooldown
            self.cooldown_counter -= 1
            self.wait = 0
            return
        improved = (self.best is None
                    or (self.mode == "min" and value < self.best - self.min_delta)
                    or (self.mode == "max" and value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                old = float(opt.get_lr())
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    if hasattr(opt, "_lr_factor"):
                        # works for every schedule shape: the optimizer
                        # multiplies its (scheduled or fixed) lr by this
                        # factor, so the min_lr-clamped reduction sticks
                        opt._lr_factor *= new / old
                    else:
                        opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:.2e} -> {new:.2e}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class MonitorCallback(Callback):
    """Feeds the ``paddle_tpu_torch.monitor`` registry from the fit loop:
    per-step wall time (``train_step_seconds`` histogram, the span also
    lands on the profiler timeline when one is recording), a running
    ``train_samples_per_second`` gauge, the last ``train_loss`` gauge
    and ``train_steps_total`` / ``train_samples_total`` counters.

    Run a fit with this callback before and after a change, and diff
    ``monitor.snapshot()``.

    Sync-free contract: the fit loop hands a DEFERRED loss per
    step; this callback must NOT force it per batch (that read would
    re-serialize the loop on the device round-trip and turn
    ``train_step_seconds`` into a sync-time measurement).  The last
    pending loss is forced into the ``train_loss`` gauge only at epoch/
    train boundaries, so the per-step span measures dispatch + device
    pipeline time.
    """

    def __init__(self):
        super().__init__()
        from .. import monitor
        self._step_s = monitor.histogram(
            "train_step_seconds", "one train_batch wall time")
        self._samples_per_s = monitor.gauge(
            "train_samples_per_second", "throughput of the last step")
        self._loss = monitor.gauge("train_loss", "last observed loss")
        self._steps = monitor.counter("train_steps_total",
                                      "train steps executed")
        self._samples = monitor.counter("train_samples_total",
                                        "samples consumed")
        self._span = None
        self._pending_loss = None

    def on_train_batch_begin(self, step, logs=None):
        from ..monitor import span
        self._span = span("train/step", histogram=self._step_s)
        self._span.__enter__()

    def on_train_batch_end(self, step, logs=None):
        if self._span is None:
            return
        self._span.__exit__(None, None, None)
        dt = self._span.elapsed
        self._span = None
        logs = logs or {}
        self._steps.inc()
        bsz = logs.get("batch_size", 0)
        if bsz:
            self._samples.inc(bsz)
            if dt > 0:
                self._samples_per_s.set(bsz / dt)
        loss = logs.get("loss")
        if loss is not None:
            self._pending_loss = loss        # deferred: forced at epoch end

    def _flush_loss(self):
        loss, self._pending_loss = self._pending_loss, None
        if loss is None:
            return
        try:
            self._loss.set(float(np.asarray(loss).ravel()[0]))
        except (TypeError, ValueError):
            pass

    def on_epoch_end(self, epoch, logs=None):
        self._flush_loss()

    def on_train_end(self, logs=None):
        self._flush_loss()


class VisualDL(Callback):
    """Scalar logging to VisualDL if installed (reference: VisualDL)."""

    def __init__(self, log_dir: str):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._step = 0

    def _get_writer(self):
        if self._writer is None:
            try:
                from visualdl import LogWriter
                self._writer = LogWriter(self.log_dir)
            except ImportError as e:
                raise ImportError(
                    "VisualDL callback requires the visualdl package") from e
        return self._writer

    def on_train_batch_end(self, step, logs=None):
        w = self._get_writer()
        for k, v in (logs or {}).items():
            if k == "batch_size":
                continue
            try:
                w.add_scalar(tag=f"train/{k}", step=self._step,
                             value=float(v))
            except (TypeError, ValueError):
                pass
        self._step += 1


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    """Assemble the effective callback list (reference: config_callbacks —
    injects ProgBarLogger/ModelCheckpoint unless the user provided them)."""
    cbs = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbs) and verbose:
        cbs.insert(0, ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbs):
        # reference config_callbacks injects an LRScheduler callback so
        # optimizer schedulers advance per step during fit
        cbs.append(LRScheduler(by_step=True))
    if not any(isinstance(c, ModelCheckpoint) for c in cbs):
        cbs.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbs)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "save_dir": save_dir, "metrics": metrics or []})
    return lst
