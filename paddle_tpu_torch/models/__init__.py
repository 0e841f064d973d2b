"""Models of the port (``paddle_tpu/models``, in part)."""
from . import (  # noqa: F401
    book,
    deepfm,
    machine_translation,
    mnist,
    resnet,
    se_resnext,
    stacked_lstm,
    transformer,
    vgg,
)
