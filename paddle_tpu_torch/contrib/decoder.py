"""High-level decoder API: InitState / StateCell / BeamSearchDecoder /
IncrementalBeamDecoder (reference contrib/decoder/beam_search_decoder.py:75).

The port of ``paddle_tpu/contrib/decoder.py``: the same calls build the
same programs, byte for byte.  ``BeamSearchDecoder`` keeps a FIXED
``[beam]`` width: states are loop-carried ``[beam, ...]`` variables,
and after each ``layers.beam_search`` step the decoder gathers them by
the returned parent pointers (the fixed-width analogue of the
reference's ``sequence_expand`` LoD fan-out).  Early stop folds into
``beam_search_decode``'s end_id truncation instead of a mid-loop
break.  ``IncrementalBeamDecoder`` carries the beam across executor
dispatches, one step at a time.

``TrainingDecoder`` is not ported yet: it drives the ``DynamicRNN``
layer, which the port lacks (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from .. import layers as L
from ..layer_helper import LayerHelper
from ..layers.nn import _tile_rows

__all__ = ["InitState", "StateCell", "BeamSearchDecoder",
           "IncrementalBeamDecoder"]


class _DecoderType:
    BEAM_SEARCH = 2


class InitState:
    """Initial hidden state: either an explicit variable or a constant
    tensor shaped like ``init_boot`` (reference
    beam_search_decoder.py:43).  ``need_reorder`` is accepted for API
    parity and ignored: the fixed-width beam never reorders rows
    outside its parent gather."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the shape of "
                "InitState.")
        else:
            self._init = L.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _BeamState:
    """Beam-mode state: a loop-carried [beam, ...] variable.  The
    decoder gathers it by parent pointers after each beam step (the
    fixed-width role of the reference's _ArrayState + sequence_expand)."""

    def __init__(self, carried):
        self.carried = carried
        self.pending = None

    def get_state(self):
        return self.carried

    def update_state(self, state):
        self.pending = state  # finalized by the decoder's parent-gather


class StateCell:
    """Named step-inputs + named hidden states + a user ``state_updater``
    that computes the new states each step (reference
    beam_search_decoder.py:157 — same contract)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object.")
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = dict(inputs)
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        if self._out_state not in self._cur_states:
            raise ValueError("out_state must be one state in states")

    # -- decoder attachment ------------------------------------------------
    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError("StateCell has already entered a decoder.")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError("StateCell not in decoder, invalid leave.")
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError("Inconsistent decoder object in StateCell.")
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must enter a decoder first.")
        if self._switched_decoder:
            raise ValueError("StateCell already switched decoder.")
        dec = self._cur_decoder_obj
        for state_name in self._state_names:
            holder = self._states_holder.setdefault(state_name, {})
            if id(dec) not in holder:
                state = self._cur_states[state_name]
                if not isinstance(state, InitState):
                    raise ValueError(
                        f"state {state_name} is {type(state)}, expected "
                        "InitState")
                if dec.type == _DecoderType.BEAM_SEARCH:
                    holder[id(dec)] = _BeamState(
                        dec._carried_state(state_name, state))
                else:
                    raise ValueError("Unknown decoder type.")
            self._cur_states[state_name] = holder[id(dec)].get_state()
        self._switched_decoder = True

    # -- user API ----------------------------------------------------------
    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError(f"Unknown state {state_name}.")
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError(f"Invalid input {input_name}.")
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise TypeError(
                    "Updater should only accept this StateCell object.")
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError(
                    f"Unknown input {input_name}. Please make sure "
                    f"{input_name} is a declared input placeholder.")
            self._inputs[input_name] = input_value
        self._state_updater(self)

    def update_states(self):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        dec_id = id(self._cur_decoder_obj)
        for state_name, holder in self._states_holder.items():
            if dec_id not in holder:
                raise ValueError(
                    "Unknown decoder object; switch_decoder not invoked.")
            holder[dec_id].update_state(self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class BeamSearchDecoder:
    """Beam-search inference decoder (reference
    beam_search_decoder.py:523 — same constructor and
    ``decode()`` / ``__call__`` contract).

    Fixed-width TPU semantics: ``init_ids``/``init_scores`` are
    ``[beam_size, 1]`` (seed scores 0 for beam 0, -inf for the rest);
    states and ``input_var_dict`` entries whose leading dim is the
    batch (1) are tiled to the beam width.  ``__call__`` returns
    ``(ids, scores)`` as ``[beam, max_len]`` padded sequences whose
    ``@LEN`` companions carry each candidate's true token length
    (``end_id`` truncation — the role of the reference's early_stop)."""

    BEFORE = 0
    IN = 1
    AFTER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None, emb_param_attr=None, score_param_attr=None,
                 score_bias_attr=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._type = _DecoderType.BEAM_SEARCH
        self._status = BeamSearchDecoder.BEFORE
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = min(topk_size, target_dict_dim)
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        # the reference's decode() creates its embedding/projection with
        # auto-generated names and relies on unique_name counters lining
        # up with the training program; these additive kwargs make the
        # weight sharing explicit instead
        self._emb_param_attr = emb_param_attr
        self._score_param_attr = score_param_attr
        self._score_bias_attr = score_bias_attr
        self._carried = {}
        self._decode_result = None
        self._state_cell._enter_decoder(self)

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    def _carried_state(self, state_name, init_state):
        """Materialize one loop-carried [beam, ...] state variable from
        its InitState (called by StateCell._switch_decoder)."""
        # states arrive at BATCH width (batch 1 for the decode loop)
        # and ALWAYS fan out to the beam width — the reference's
        # sequence_expand role.  Never pre-tile the inputs: an
        # unconditional tile is the only unambiguous rule under dynamic
        # (-1) batch dims.
        init = _tile_rows(init_state.value, self._beam_size)
        carried = L.assign(init)  # private copy the loop mutates
        self._carried[state_name] = carried
        return carried

    def decode(self):
        """Build the fixed-width beam loop: embed previous ids, run the
        state updater, score with a softmax projection, take
        ``topk_size`` candidates, advance one ``beam_search`` step, and
        gather every carried state by the returned parent pointers."""
        if self._status != BeamSearchDecoder.BEFORE:
            raise ValueError("decode() can only be invoked once")
        self._status = BeamSearchDecoder.IN
        cell = self._state_cell
        bw = self._beam_size

        # materialize the loop-carried [beam, ...] states in the PARENT
        # block BEFORE entering the While: StateCell switches lazily on
        # the first get_state(), which used to happen inside the loop
        # body — so the carried vars (and their assign-from-init) were
        # created in the SUB-block, never qualified as loop carries,
        # and re-initialized every iteration: beam states silently
        # froze at their init values (decode degenerated to
        # conditioning on the last token only).  Pinned by the
        # incremental-vs-whole-sequence exactness test in
        # tests/test_torch_beam_decoder.py.
        if not cell._switched_decoder:
            cell._switch_decoder()

        pre_ids = L.assign(self._init_ids)
        pre_scores = L.assign(self._init_scores)
        ids_arr = L.create_array("int64", [bw], max_len=self._max_len)
        par_arr = L.create_array("int64", [bw], max_len=self._max_len)
        score_arr = L.create_array("float32", [bw], max_len=self._max_len)

        # beam-tiled statics for the cell's non-word inputs
        feed_static = {}
        for name, var in self._input_var_dict.items():
            if name not in cell._inputs:
                raise ValueError(f"Variable {name} not found in "
                                 "StateCell!")
            feed_static[name] = _tile_rows(var, bw)

        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", self._max_len)
        cond = L.less_than(i, n)
        with L.While(cond).block():
            prev_emb = L.embedding(
                pre_ids, [self._target_dict_dim, self._word_dim],
                is_sparse=self._sparse_emb,
                param_attr=self._emb_param_attr)    # [bw, word_dim]
            feed = dict(feed_static)
            for input_name in cell._inputs:
                if input_name not in feed:
                    feed[input_name] = prev_emb
            cell.compute_state(inputs=feed)
            cell.update_states()                    # stash pending states
            current = cell.out_state()
            probs = L.fc(current, self._target_dict_dim, act="softmax",
                         param_attr=self._score_param_attr,
                         bias_attr=self._score_bias_attr)
            topk_scores, topk_ids = L.topk(probs, k=self._topk_size)
            acc = L.elementwise_add(L.log(topk_scores), pre_scores)
            sel_ids, sel_scores, parent = L.beam_search(
                pre_ids, pre_scores, topk_ids, acc,
                beam_size=bw, end_id=self._end_id)
            # beams reordered: every carried state follows its parent
            for state_name, carried in self._carried.items():
                holder = cell._states_holder[state_name][id(self)]
                pending = holder.pending
                if pending is None:  # state never updated this step
                    pending = carried
                L.assign(L.gather(pending, parent), carried)
                holder.pending = None
                cell.set_state(state_name, carried)
            L.array_write(L.squeeze(sel_ids, [1]), i, ids_arr)
            L.array_write(parent, i, par_arr)
            L.array_write(L.squeeze(sel_scores, [1]), i, score_arr)
            L.assign(sel_ids, pre_ids)
            L.assign(sel_scores, pre_scores)
            L.increment(i, 1)
            L.less_than(i, n, cond=cond)

        self._decode_result = L.beam_search_decode(
            ids_arr, par_arr, beam_size=bw, end_id=self._end_id,
            scores_array=score_arr)
        self._status = BeamSearchDecoder.AFTER
        self._state_cell._leave_decoder(self)

    def __call__(self):
        if self._status != BeamSearchDecoder.AFTER:
            raise ValueError("Output of BeamSearchDecoder can only be "
                             "visited after decode().")
        return self._decode_result.ids, self._decode_result.scores

    @property
    def result(self):
        """The full BeamDecodeResult (ids/scores/cand_len/src_len)."""
        return self._decode_result


class IncrementalBeamDecoder:
    """Beam search one decode step at a time — the decode plane's
    incremental twin of :class:`BeamSearchDecoder`.

    Where ``BeamSearchDecoder.decode()`` compiles the whole beam loop
    into ONE While program, this class carries the beam state
    (``pre_ids`` / ``pre_scores`` / the per-step selections) ACROSS
    executor dispatches, so a serving loop can interleave beam steps of
    many requests (token-level continuous batching) and stream partial
    hypotheses.  Exactness contract: each :meth:`step` runs the same op
    chain the While body compiles (``log`` → ``elementwise_add`` →
    ``beam_search``) as a one-step program, and :meth:`finalize` runs
    the same ``beam_search_decode`` backtrack op over the stacked
    per-step selections — so after ``max_len`` steps the result is
    bit-identical to the whole-sequence decoder's (pinned by
    tests/test_torch_beam_decoder.py on the machine-translation
    decoder pattern).

    ``executor``: where the two programs run; by default an inference
    executor on ``cuda:0``.  Its fetches are synchronous (the port's
    ``Executor.run`` has no ``LazyFetch``), so the reference's
    ``sync=True`` is not passed.

    The caller owns the model half of each step (embed the previous
    ids, run the cell, score, top-k — exactly what it would put inside
    ``decoder.block()``) and must gather its carried states by the
    returned ``parent`` pointers, the role the whole-sequence decoder's
    in-loop ``L.gather`` plays.
    """

    def __init__(self, beam_size: int, end_id: int, topk_size: int,
                 executor=None):
        from ..core.executor import Executor, Scope
        from ..core.program import Program, program_guard
        from ..core import unique_name

        self.beam_size = int(beam_size)
        self.end_id = int(end_id)
        self.topk_size = int(topk_size)
        self._exe = executor if executor is not None \
            else Executor(training=False)
        self._scope = Scope()
        self._ids = []       # per-step selected ids     [bw]
        self._parents = []   # per-step parent pointers  [bw]
        self._scores = []    # per-step selected scores  [bw]
        self.pre_ids = None      # [bw, 1] int64
        self.pre_scores = None   # [bw, 1] float32
        # the one-step program: the While body's scoring-to-selection
        # tail (log + add + beam_search), compiled once, hit thereafter
        self._step_prog = Program()
        with program_guard(self._step_prog, Program()), \
                unique_name.guard():
            from .. import layers as L
            pre_ids = L.data("ibd_pre_ids", [1], dtype="int64")
            pre_scores = L.data("ibd_pre_scores", [1])
            cand_ids = L.data("ibd_cand_ids", [self.topk_size],
                              dtype="int64")
            cand_probs = L.data("ibd_cand_probs", [self.topk_size])
            acc = L.elementwise_add(L.log(cand_probs), pre_scores)
            sel_ids, sel_scores, parent = L.beam_search(
                pre_ids, pre_scores, cand_ids, acc,
                beam_size=self.beam_size, end_id=self.end_id)
            self._step_fetches = [sel_ids.name, sel_scores.name,
                                  parent.name]

    def start(self, init_ids=None, init_scores=None) -> None:
        """Seed the beam (the ``init_ids``/``init_scores`` contract of
        BeamSearchDecoder: zeros, and 0 / -1e9 scores so identical
        initial beams don't multiply)."""
        import numpy as np
        bw = self.beam_size
        self.pre_ids = (np.zeros((bw, 1), "int64") if init_ids is None
                        else np.asarray(init_ids, "int64").reshape(bw, 1))
        if init_scores is None:
            init_scores = [[0.0]] + [[-1e9]] * (bw - 1)
        self.pre_scores = np.asarray(init_scores,
                                     "float32").reshape(bw, 1)
        self._ids, self._parents, self._scores = [], [], []

    def step(self, cand_ids, cand_probs):
        """Advance one beam step.  ``cand_ids``/``cand_probs``:
        [beam, topk_size] top-k tokens and their (softmax) probabilities
        from the caller's cell+scoring dispatch.  Returns ``(sel_ids
        [bw, 1], parent [bw])`` — gather every carried model state by
        ``parent`` before computing the next step's candidates."""
        import numpy as np
        if self.pre_ids is None:
            self.start()
        bw = self.beam_size
        feed = {"ibd_pre_ids": self.pre_ids,
                "ibd_pre_scores": self.pre_scores,
                "ibd_cand_ids": np.asarray(cand_ids,
                                           "int64").reshape(bw, -1),
                "ibd_cand_probs": np.asarray(cand_probs,
                                             "float32").reshape(bw, -1)}
        sel_ids, sel_scores, parent = self._exe.run(
            self._step_prog, feed=feed, fetch_list=self._step_fetches,
            scope=self._scope)
        sel_ids = np.asarray(sel_ids).reshape(bw, 1)
        sel_scores = np.asarray(sel_scores).reshape(bw, 1)
        parent = np.asarray(parent).reshape(bw)
        self._ids.append(sel_ids[:, 0].copy())
        self._parents.append(parent.copy())
        self._scores.append(sel_scores[:, 0].copy())
        self.pre_ids, self.pre_scores = sel_ids, sel_scores
        return sel_ids, parent

    @property
    def steps(self) -> int:
        return len(self._ids)

    def finalize(self):
        """Backtrack the accumulated selections through the SAME
        ``beam_search_decode`` op the whole-sequence decoder ends with;
        returns a numpy ``BeamDecodeResult`` (ids [bw, T], scores,
        cand_len [bw], src_len [1])."""
        import numpy as np
        from ..core.program import Program, program_guard
        from ..core import unique_name
        from ..layer_helper import LayerHelper
        from ..layers.control_flow import BeamDecodeResult
        from .. import layers as L

        if not self._ids:
            raise ValueError("finalize() before any step()")
        bw, t = self.beam_size, len(self._ids)
        prog = Program()
        with program_guard(prog, Program()), unique_name.guard():
            ids_v = L.data("ibd_arr_ids", [bw], dtype="int64")
            par_v = L.data("ibd_arr_parents", [bw], dtype="int64")
            sc_v = L.data("ibd_arr_scores", [bw])
            len_v = L.data("ibd_arr_len", [1], dtype="int64",
                           append_batch_size=False)
            helper = LayerHelper("beam_search_decode")
            sents = helper.create_variable_for_type_inference(
                "int64", shape=(bw, t))
            cand_len = helper.create_variable_for_type_inference(
                "int64", shape=(bw,), stop_gradient=True)
            src_len = helper.create_variable_for_type_inference(
                "int64", shape=(1,), stop_gradient=True)
            scores = helper.create_variable_for_type_inference(
                "float32", shape=(bw, t))
            helper.append_op(
                "beam_search_decode",
                {"Ids": [ids_v], "Parents": [par_v], "Scores": [sc_v],
                 "ArrayLen": [len_v]},
                {"SentenceIds": [sents], "SentenceLen": [cand_len],
                 "SourceLen": [src_len], "SentenceScores": [scores]},
                {"end_id": self.end_id, "beam_size": self.beam_size})
            fetches = [sents.name, scores.name, cand_len.name,
                       src_len.name]
        feed = {"ibd_arr_ids": np.stack(self._ids),
                "ibd_arr_parents": np.stack(self._parents),
                "ibd_arr_scores": np.stack(self._scores),
                "ibd_arr_len": np.asarray([t], "int64")}
        out = self._exe.run(prog, feed=feed, fetch_list=fetches,
                            scope=self._scope)
        ids, scores, cand_len, src_len = (np.asarray(v) for v in out)
        return BeamDecodeResult(ids, scores, cand_len, src_len)
