from sgl_tpu_torch.tricks.correct_and_smooth import CorrectAndSmooth  # noqa: F401
from sgl_tpu_torch.tricks.utils import (  # noqa: F401
    label_propagation,
    loge_bce_loss,
    loge_cross_entropy_loss,
)
