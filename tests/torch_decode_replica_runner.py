"""One decode replica of the PyTorch port as a supervised worker process.

The port's copy of ``tests/decode_replica_runner.py``: it reads the
fleet registry and its replica id from the environment, serves a
deterministic Transformer LM behind an OVERCOMMITTED block pool, and
drains gracefully on SIGTERM.  Its environment:

- ``PADDLE_REGISTRY``, ``REPLICA_ID`` — as the reference's runner;
- ``REPLICA_DEVICE`` — the device (``cuda:0`` when unset; the CPU tests
  pass ``cpu``);
- ``REPLICA_WIDTH`` — ``tiny`` (the reference runner's ``TINY``, 4
  slots, block 4, 13 blocks: four streams of 6 + 20 tokens must
  preempt) or ``full`` (Transformer-base at ``chip_smoke.py``'s
  ``FULL`` width, 4 slots, block 16, 25 blocks: four streams of 16 +
  112 tokens, 8 blocks each, must preempt);
- ``REPLICA_SEED_FILE`` — a JSON file ``{"seed": n}`` the parent wrote;
  the weights are ``init_params(n)``, the reference's seeded draws, so
  the parent can hold the replica's tokens against an engine of its
  own on the same weights;
- ``REPLICA_REPORT`` (optional) — where, at the SIGTERM drain, the
  replica writes its engine's decode steps, the paged decode kernel's
  launch count (K4, ``decode_attention.launches``) and its pool's
  ``leaked()`` as JSON.

An armed ``FLAGS_fault_inject=kill_after:decode_preempt`` (the chaos
drill's ``env_once``) hard-kills the process the first time its engine
preempts a stream.
"""
import json
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from paddle_tpu_torch.decode import (DecodeEngine, DecodeServer,  # noqa: E402
                                     LMConfig, TransformerLM)
from paddle_tpu_torch.kernels import attention as A  # noqa: E402

TINY = LMConfig(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
                max_seq_len=32)
FULL = LMConfig(vocab=32000, d_model=512, n_head=8, d_ffn=2048, n_layer=6,
                max_seq_len=256)
# width -> (config, slots, block tokens, blocks, prefill buckets)
WIDTHS = {"tiny": (TINY, 4, 4, 13, (8,)),
          "full": (FULL, 4, 16, 25, (16, 32, 64, 128))}


def main() -> int:
    cfg, slots, bs, blocks, buckets = WIDTHS[
        os.environ.get("REPLICA_WIDTH", "tiny")]
    device = os.environ.get("REPLICA_DEVICE") or None
    with open(os.environ["REPLICA_SEED_FILE"]) as f:
        seed = int(json.load(f)["seed"])
    lm = TransformerLM(cfg, device=device)
    params = lm.init_params(seed=seed)
    eng = DecodeEngine(lm, params, name="lm", max_slots=slots,
                       block_tokens=bs, num_blocks=blocks,
                       prefill_buckets=buckets, max_queue=32,
                       prefix_cache=False, overcommit=True, device=device)
    srv = DecodeServer("127.0.0.1:0", engines={"lm": eng},
                       registry_ep=os.environ["PADDLE_REGISTRY"],
                       replica_id=os.environ["REPLICA_ID"],
                       lease_ttl=0.3, own_engines=False)
    srv.start()
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())
    done.wait()
    srv.stop(drain=True)
    eng.drain(timeout=60)
    report = os.environ.get("REPLICA_REPORT")
    if report:
        with open(report + ".tmp", "w") as f:
            json.dump({"decode_steps": int(eng.stats.steps.value),
                       "k4_launches": int(A.decode_attention.launches),
                       "n_layer": cfg.n_layer,
                       "preempts": int(eng._pstats.preempts.value),
                       "leaked": int(eng.cache.allocator.leaked())}, f)
        os.replace(report + ".tmp", report)
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
