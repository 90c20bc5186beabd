"""The reference's example recipes on the port (counterparts of
``examples/run_*.py``): Criteo classification, MovieLens regression and
multi-value, DIN, DIEN, multi-task learning and the streamed Criteo fit.

Each ``run_*`` module exposes ``main(epochs=..., device="cuda")`` and runs
as ``python -m deepctr_tpu_torch.examples.run_din``; without CUDA it
raises unless a device is given (``main(device="cpu")``).  The data comes
from the in-repo samples under ``examples/data/`` and is prepared with
the ``csv`` module and numpy (:mod:`.data_utils`): neither pandas nor
sklearn is needed.
"""
