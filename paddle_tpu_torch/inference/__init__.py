"""Inference: the Predictor over the port's executor and the program
passes that run before it (the port of ``paddle_tpu/inference``).

``create_predictor(AnalysisConfig(dir))`` loads a model saved by
``io.save_inference_model`` (by either package), runs the passes and
returns a :class:`Predictor`; ``clone()`` shares program and weights
with its own executor, for one clone per serving thread.
"""
from . import passes  # noqa: F401
from .predictor import (AnalysisConfig, NativeConfig, Predictor,  # noqa: F401
                        create_paddle_predictor, create_predictor)

__all__ = ["AnalysisConfig", "NativeConfig", "Predictor",
           "create_paddle_predictor", "create_predictor", "passes"]
