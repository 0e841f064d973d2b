"""Predictor: the PaddlePredictor analogue over the port's executor.

The port of ``paddle_tpu/inference/predictor.py`` (the reference's
``inference/api/paddle_inference_api.h:141``, ``api_impl.cc`` and
``analysis_predictor.cc``, which runs the IR passes first).

``create_predictor(config)`` loads a saved inference model onto the
config's device (``cuda:0`` unless the config names another place),
stamps ``is_test``, runs the config's passes (the fusion passes, then
the added ones in their order: ``convert_to_nhwc``, ``quantize_int8``
when int8 is enabled) and wraps the program in a
:class:`Predictor`, whose inference executor
(``Executor(training=False)``) runs every op in its test branch and
sends the stamped ``mul``/``fused_fc`` ops to K5.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from .. import io as _io
from ..core import flags as _flags
from ..core.executor import Executor, Scope, scope_guard
from ..core.program import Program
from ..platform import CPUPlace

__all__ = ["AnalysisConfig", "NativeConfig", "Predictor",
           "create_paddle_predictor", "create_predictor"]


class AnalysisConfig:
    """Predictor configuration (NativeConfig/AnalysisConfig:183).  The
    place defaults to the card (``cuda:0``); ``disable_gpu()`` asks for
    the CPU and the plain versions of the kernels."""

    def __init__(self, model_dir: Optional[str] = None):
        self.model_dir = model_dir
        self.ir_optim = True
        self.place = None
        self._passes = ["fuse_fc_lstm", "fuse_fc_gru",
                        "fuse_conv_bn", "fuse_fc_act"]

    def set_model(self, model_dir: str) -> None:
        self.model_dir = model_dir

    def disable_gpu(self) -> None:
        """Run on the CPU: the kernels' plain versions."""
        self.place = CPUPlace()

    def switch_ir_optim(self, flag: bool = True) -> None:
        self.ir_optim = flag

    def pass_names(self) -> List[str]:
        return list(self._passes) if self.ir_optim else []

    def delete_pass(self, name: str) -> None:
        self._passes = [p for p in self._passes if p != name]

    def add_pass(self, name: str) -> None:
        """Append an optional pass (``"convert_to_nhwc"``, the
        channels-last layout rewrite) to the ir_optim pipeline."""
        if name not in self._passes:
            self._passes.append(name)

    def enable_int8(self) -> None:
        """Calibrate the loaded model for int8 serving: appends the
        ``quantize_int8`` pass, which folds QAT fake-quant ops into
        harvested scales (the weights' abs-max when there are no QAT
        stats) and stamps mul/fused_fc ops for K5 (``kernels/quant.py``).
        After the fusion passes, so the epilogue absorbs fused_fc's bias
        and activation too."""
        self.add_pass("quantize_int8")

    def int8_enabled(self) -> bool:
        return "quantize_int8" in self._passes


NativeConfig = AnalysisConfig


class Predictor:
    """A program, its weights and an inference executor, with the
    clone-per-thread contract."""

    def __init__(self, program: Program, feed_names: Sequence[str],
                 fetch_names: Sequence[str], scope: Scope, place=None):
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._scope = scope          # shared weights (clones keep sharing)
        self._place = place
        self._exe = Executor(place, training=False)
        self._lock = threading.Lock()  # one run at a time per predictor

    # -- PaddlePredictor::Run ---------------------------------------------
    def run(self, inputs) -> list:
        """``inputs``: dict name -> array, or a list in feed order.
        Returns the fetches as numpy arrays."""
        if not isinstance(inputs, dict):
            inputs = dict(zip(self._feed_names, inputs))
        missing = [n for n in self._feed_names if n not in inputs]
        if missing:
            raise ValueError(f"predictor missing feeds: {missing}")
        with self._lock:
            return self._exe.run(self._program, feed=inputs,
                                 fetch_list=self._fetch_names,
                                 scope=self._scope)

    # -- warm start (serving plane) ---------------------------------------
    def warm_start(self, feed_specs) -> dict:
        """Prepare this predictor's plans before the first request
        (``Executor.warm_start``): ``feed_specs`` is one name -> spec
        dict, or a list of them (a serving bucket ladder)."""
        with self._lock:
            return self._exe.warm_start(self._program, feed_specs,
                                        self._fetch_names,
                                        scope=self._scope)

    def feed_specs_for_batch(self, batch_size: int,
                             sample_shapes: Optional[Dict] = None) -> Dict:
        """One warm_start spec dict at ``batch_size``, shapes from the
        program's static feed declarations (``(-1, *sample)``);
        ``sample_shapes`` fills feeds with symbolic non-batch dims."""
        block = self._program.global_block
        specs = {}
        for n in self._feed_names:
            var = block.var_or_none(n)
            dtype = (var.dtype if var is not None and var.dtype is not None
                     else "float32")
            if sample_shapes and n in sample_shapes:
                sample = tuple(int(s) for s in sample_shapes[n])
            else:
                if var is None or var.shape is None:
                    raise ValueError(
                        f"feed {n!r} has no static declaration; pass "
                        "sample_shapes")
                sample = tuple(var.shape[1:])
                if any(s < 0 for s in sample):
                    raise ValueError(
                        f"feed {n!r} declares symbolic dims {var.shape}; "
                        "pass sample_shapes with the served padded shape")
            specs[n] = ((int(batch_size),) + sample, dtype)
        return specs

    # -- PaddlePredictor::Clone -------------------------------------------
    def clone(self) -> "Predictor":
        """Same program and shared weights, its own executor: one clone
        per serving thread (api_impl.cc Clone)."""
        return Predictor(self._program, self._feed_names,
                         self._fetch_names, self._scope, self._place)

    @property
    def feed_names(self) -> List[str]:
        return list(self._feed_names)

    @property
    def fetch_names(self) -> List[str]:
        return list(self._fetch_names)

    def program(self) -> Program:
        return self._program


def create_predictor(config: AnalysisConfig) -> Predictor:
    """Load an inference model directory and build a Predictor
    (CreatePaddlePredictor:211; the analysis path runs the passes
    first)."""
    from . import passes as P

    if not config.model_dir:
        raise ValueError("AnalysisConfig.model_dir is not set")
    scope = Scope()
    exe = Executor(config.place)
    with scope_guard(scope):
        program, feed_names, fetch_vars = _io.load_inference_model(
            config.model_dir, exe)
    # inference programs run in test mode: stamp is_test on stateful ops
    P.apply_is_test(program)
    fetch_names = [v.name for v in fetch_vars]
    # FLAGS_int8_inference: the fleet-wide switch for the int8
    # calibration pass, as if every config called enable_int8()
    if _flags.get_flags("int8_inference") and config.ir_optim:
        config.enable_int8()
    for name in config.pass_names():
        # fetch targets count as external uses: never fused away
        getattr(P, name)(program, scope, keep_vars=fetch_names)
    return Predictor(program, feed_names, fetch_names, scope, config.place)


create_paddle_predictor = create_predictor
