"""Feature-interaction layers (counterpart of
``deepctr_tpu/layers/interaction.py``).  Every layer consumes a stacked
``[B, F, E]`` field tensor."""

from torch import nn

from ..ops import fm_cross


class FM(nn.Module):
    """Factorization-machine pairwise interaction:
    ``0.5 * sum_e((sum_f v)^2 - sum_f v^2)`` over [B,F,E] -> [B,1].
    """

    def forward(self, inputs):
        return fm_cross(inputs)
