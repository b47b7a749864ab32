"""Plant faults in partitioned training and read [tp-train] (a)'s gates on
them, on four NVIDIA GPUs.

    python3 tp_train_faults.py      # from the repository root, four cards

Runs ``chip_smoke.py``'s [tp-train] (a) (Qwen2.5-32B at 2 layers,
Llama-4-Scout at 1 layer, RecurrentGemma-9B at 3 layers and
Whisper-large-v3 at 4 + 4 layers over 1500 frames, full width, bf16, fake
w4/a8/attn7, 3 LAMB steps on 4 x 256 tokens, mesh (data 2, model 2)) once
as it is and once under each planted fault, every run held on rank 0
against the one-rank run of the same tree (``chip_smoke.tt_gate``).  The
gates' limits were set on the decoder LMs; the two families show whether
they part sound runs from faulty ones there too.  The faults, each a plausible slip
in ``distributed/partition.py`` or ``collectives.py``:

- ``grads-not-summed``: ``partition.reduce_grads`` left out, so each data
  rank steps on the gradient of its own rows only;
- ``max-backward-local``: a grid max's backward (``partition._Max``) without
  its sum of the incoming gradient over the ranks the grid spans;
- ``shared-backward-identity``: the shared input's backward
  (``collectives._SharedInput``) without its sum over "model", so a
  column-parallel input misses the other ranks' parts of its gradient.

Prints the card's name and power limit, one line of readings per run
beside the gates' limits, and a last JSON line with every reading.  Exits
non-zero if the sound run fails a gate or a rank fails; a planted fault
that passes every gate is reported, not an error.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

import chip_smoke as cs

FAULTS = ("grads-not-summed", "max-backward-local",
          "shared-backward-identity")
# the configs of [tp-train] (a) that are read: the decoder LMs, and the
# families whose partitioned programs differ from theirs (the RG-LRU split
# by d_rnn; Whisper's heads, with the encoder's states into each
# cross-attention)
CONFIGS = cs.TT_SHORT + tuple(c for c in cs.TT_FAMILIES
                              if c[0] != "mamba2-130m")


@contextlib.contextmanager
def planted(fault):
    """Within: the partitioned program with ``fault`` (None: sound)."""
    import torch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    saved = [(partition, "reduce_grads", partition.reduce_grads),
             (partition._Max, "backward", partition._Max.backward),
             (col._SharedInput, "backward", col._SharedInput.backward)]

    def max_backward(ctx, g):
        xa, out = ctx.saved_tensors
        hit = xa == out
        count = col.reduce_sum(hit.sum(dim=ctx.dims, keepdim=True,
                                       dtype=torch.float32), ctx.groups)
        return (g / count.to(xa.dtype)) * hit.to(xa.dtype), None, None

    if fault == "grads-not-summed":
        partition.reduce_grads = lambda grads, shards: grads
    elif fault == "max-backward-local":
        partition._Max.backward = staticmethod(max_backward)
    elif fault == "shared-backward-identity":
        col._SharedInput.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)


def run(rank, world, device="cuda"):
    """Every run of every config on this rank; rank 0's readings."""
    import torch
    import torch.distributed as dist
    say = cs.log if rank == 0 else (lambda *a: None)
    mesh = cs.tt_mesh(world, device)
    out = []
    for arch, layers in CONFIGS:
        cfg = cs.tt_config(arch, layers)
        batch = cs.tt_batch(cfg, 7, device)
        one = ref = None
        if rank == 0:
            one, loss, gn, _ = cs.tt_one_rank(cfg, batch, device)
            ref = (loss, gn)
        dist.barrier()
        for fault in (None,) + FAULTS:
            with planted(fault):
                local, state, r = cs.tt_partitioned(cfg, batch, mesh, one,
                                                    ref, device)
            del local, state
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            if rank == 0:
                ok, line = cs.tt_gate(r, world)
                caught = not (ok and r["whole_same"] and r["finite"])
                say(f"[tp-train faults] {cfg.name}, {fault or 'sound'}: "
                    f"losses {' '.join(f'{x:.5f}' for x in r['loss'])}; "
                    f"{line}; whole leaves' gradients bitwise "
                    f"{r['whole_same']}: "
                    + ("fails a gate" if caught else "passes every gate"))
                out.append(dict(config=cfg.name, fault=fault, caught=caught,
                                **{k: r[k] for k in (
                                    "loss", "gn", "loss_gap", "gn_gap",
                                    "moved", "moved_equal", "update_gap",
                                    "whole_same")}))
        del one
    return out


def rank_main(rank, world, d):
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(cs.ROOT / "src"))
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{d}/store",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=cs.DIST_JOIN_S))
    try:
        out = run(rank, world)
        if rank == 0:
            with open(os.path.join(d, "readings.json"), "w") as f:
                json.dump(out, f)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main():
    import torch
    import torch.multiprocessing as mp
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    world = torch.cuda.device_count()
    if world < 4:
        raise SystemExit(f"four cards needed, {world} here")
    cs.log(cs.card_line())
    d = tempfile.mkdtemp(prefix="ttf")
    procs = [mp.get_context("spawn").Process(target=rank_main,
                                             args=(r, world, d))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs) and \
                not any(p.exitcode for p in procs) and \
                time.perf_counter() - t0 < cs.DIST_JOIN_S:
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"rank exit codes {codes}")
    with open(os.path.join(d, "readings.json")) as f:
        out = json.load(f)
    sound_failed = [r["config"] for r in out
                    if r["fault"] is None and r["caught"]]
    print(json.dumps({"runs": out}))
    if sound_failed:
        raise SystemExit(f"the sound run fails a gate: {sound_failed}")


if __name__ == "__main__":
    main()
