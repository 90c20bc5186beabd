"""Keras-style training callbacks.

Counterpart of ``deepctr_tpu/callbacks.py`` (``Callback``,
``CallbackList``, ``History``, ``EarlyStopping``, ``ModelCheckpoint``).
"""

import numpy as np


class Callback(object):
    def __init__(self):
        self.model = None

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class CallbackList(object):
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_train_begin(self, logs=None):
        for c in self.callbacks:
            c.on_train_begin(logs)

    def on_train_end(self, logs=None):
        for c in self.callbacks:
            c.on_train_end(logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)


class History(Callback):
    """Records epoch logs; returned by ``fit``."""

    def on_train_begin(self, logs=None):
        if not hasattr(self, "epoch"):
            self.epoch = []
            self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


def _monitor_op(mode, monitor):
    if mode == "min":
        return np.less
    if mode == "max":
        return np.greater
    # auto
    if "acc" in monitor or monitor.startswith("fmeasure") or "auc" in monitor:
        return np.greater
    return np.less


class EarlyStopping(Callback):
    """Stop training when the monitored quantity stops improving."""

    def __init__(self, monitor="val_loss", min_delta=0, patience=0, verbose=0,
                 mode="auto", baseline=None, restore_best_weights=False):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.restore_best_weights = restore_best_weights
        self.monitor_op = _monitor_op(mode if mode in ("min", "max") else "auto",
                                      monitor)
        self.min_delta = (self.min_delta if self.monitor_op == np.greater
                          else -self.min_delta)

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self.best_weights = None
        if self.baseline is not None:
            self.best = self.baseline
        else:
            self.best = np.inf if self.monitor_op == np.less else -np.inf

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            print("EarlyStopping: monitored metric %r missing from logs "
                  "(have: %s)" % (self.monitor,
                                  ", ".join(sorted(logs or {}))))
            return
        if self.monitor_op(current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
            if self.restore_best_weights:
                self.best_weights = self.model.get_weights()
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True
                if self.restore_best_weights and self.best_weights is not None:
                    if self.verbose > 0:
                        print("EarlyStopping: rolling weights back to the "
                              "best epoch")
                    self.model.set_weights(self.best_weights)

    def on_train_end(self, logs=None):
        if self.stopped_epoch > 0 and self.verbose > 0:
            print("EarlyStopping: halted after epoch %d"
                  % (self.stopped_epoch + 1))


class ModelCheckpoint(Callback):
    """Save the model (or weights only) after every ``period`` epochs,
    optionally keeping only the best according to ``monitor``
    (``deepctr_tpu/callbacks.py:141-196``).  ``filepath`` may hold
    ``{epoch}`` and the epoch logs' keys as format fields."""

    def __init__(self, filepath, monitor="val_loss", verbose=0,
                 save_best_only=False, save_weights_only=False, mode="auto",
                 period=1):
        super().__init__()
        self.filepath = filepath
        self.monitor = monitor
        self.verbose = verbose
        self.save_best_only = save_best_only
        self.save_weights_only = save_weights_only
        self.period = period
        self.epochs_since_last_save = 0
        self.monitor_op = _monitor_op(mode if mode in ("min", "max") else "auto",
                                      monitor)
        self.best = np.inf if self.monitor_op == np.less else -np.inf

    def _save(self, filepath):
        if self.save_weights_only:
            self.model.save_weights(filepath)
        else:
            self.model.save(filepath)

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        self.epochs_since_last_save += 1
        if self.epochs_since_last_save >= self.period:
            self.epochs_since_last_save = 0
            filepath = self.filepath.format(epoch=epoch + 1, **logs)
            if self.save_best_only:
                current = logs.get(self.monitor)
                if current is None:
                    print("ModelCheckpoint: monitored metric %r missing "
                          "from logs (have: %s) — nothing saved this epoch"
                          % (self.monitor, ", ".join(sorted(logs))))
                else:
                    if self.monitor_op(current, self.best):
                        if self.verbose > 0:
                            print("epoch %d: new best %s (%.5f, was %.5f) "
                                  "-> %s" % (epoch + 1, self.monitor,
                                             current, self.best, filepath))
                        self.best = current
                        self._save(filepath)
                    elif self.verbose > 0:
                        print("epoch %d: %s=%.5f, best remains %.5f — "
                              "not saving" % (epoch + 1, self.monitor,
                                              current, self.best))
            else:
                if self.verbose > 0:
                    print("epoch %d: checkpoint -> %s"
                          % (epoch + 1, filepath))
                self._save(filepath)
