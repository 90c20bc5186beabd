"""Version freshness check, without network.

The port's copy of ``deepctr_tpu/utils/version.py``.  The deployment
environment pushes the known latest version through
``DEEPCTR_TPU_LATEST_VERSION`` (set, for example, by a cluster launcher
from an internal index); this check only compares and logs.  Without the
variable it does nothing.
"""

import logging
import os

_logger = logging.getLogger(__name__)


def _parse(v):
    parts = []
    for tok in str(v).split("."):
        digits = "".join(ch for ch in tok if ch.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def check_version(version):
    """Log a notice when the environment knows of a newer version.
    Returns whether it is newer, or None without the variable."""
    latest = os.environ.get("DEEPCTR_TPU_LATEST_VERSION")
    if not latest:
        return None
    newer = _parse(latest) > _parse(version)
    if newer:
        _logger.warning(
            "deepctr_tpu_torch %s is installed but %s is available: "
            "upgrade for the latest models and fixes.", version, latest)
    return newer
