from sgl_tpu_torch.utils.config import TrainConfig  # noqa: F401
