"""Both sides of ``tests/test_torch_distributed.py``, each in processes of
its own.

    python tests/_torch_dist_util.py jax OUT.npz
        The reference on host meshes (the caller sets
        ``--xla_force_host_platform_device_count=8``): the inputs it makes and every output, in one
        npz.  Meshes are ``jax.sharding.Mesh`` over the first 4 devices
        (``jax.make_mesh`` makes Explicit axes, which the reference's
        ``shard()`` refuses); the elastic case uses 8 and 6 devices.
    python tests/_torch_dist_util.py rank JOB RANK WORLD STORE REF OUT_DIR
        One gloo rank of the port (no JAX imported): JOB "main" (world 4)
        runs every case on the reference's inputs, "elastic8" / "elastic6"
        the elastic round trip, "partition" (world 4) the partitioned ring
        serving of ``tests/test_torch_partition.py``, "families" (world
        4) that of the recurrent and encoder-decoder families in
        ``tests/test_torch_partition_families.py``; each rank writes
        OUT_DIR/JOB-RANK.npz.  "train" (world 4) runs the partitioned
        training of the decoder LMs (``tests/test_torch_partition_train.py``),
        "trainfam" (world 4) that of the recurrent and encoder-decoder
        families (``tests/test_torch_partition_train_families.py``);
        "shardlocal" and "shardjax" (world 4) the shard bodies on
        rank-local operands (``tests/test_torch_partition_shard_bodies.py``):
        the first against the same bodies on global tensors and needing
        nothing of JAX, the second against ``jaxshard``'s outputs; "sp"
        (world 4) the residual's sequence split in serving
        (``tests/test_torch_partition_sp.py``; REF is the npz ``jaxsp``
        writes beside it, read once it exists) and "sptrain" (world 4) in
        training (``tests/test_torch_partition_sp_train.py``; REF is the
        npz ``jaxsptrain`` writes, read the same way).
    python tests/_torch_dist_util.py jaxshard bodies|serve|train OUT.npz
        The reference's shard bodies (``int_bf16_reduce``, ``moe_a2a``)
        on host meshes of 2 and 4 devices, with the inputs it makes.
    python tests/_torch_dist_util.py jaxsp OUT.npz
        The reference's own ``Rules(seq_tp=("model",))`` serving run on a
        4-device host mesh (SP_* constants).
    python tests/_torch_dist_util.py jaxsptrain OUT.npz
        The reference's own ``seq_tp`` train cell (Qwen2.5 SMOKE, fake
        mode) on a 4-device host mesh: loss, gradients and every
        fake-quant call's (x, delta, output).
    python tests/_torch_dist_util.py jaxdryrun OUT.json
        The reference's dry-run cells (``repro/launch/dryrun.py``, imported
        first: 512 host devices) of DRYRUN_LAYOUT_CELLS: each argument
        leaf's global shape, shard shape on the production mesh and item
        size, nothing compiled.  The rank job "dryrun" (world 4) runs
        DRYRUN_CASES through ``repro_torch.launch.dryrun.measure`` on real
        CPU tensors under gloo (``tests/test_torch_dryrun.py``).
        :func:`launch` and :func:`join` start and wait for a job's ranks.

Arrays cross as npz: trees flatten to "/"-joined keys, and a bfloat16
array travels widened to float32 under a key ending in "@bf16" (exact).
"""
import itertools
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")

D_IN, D_OUT = 64, 48
# (name, mesh, x shape, x dtype, packed weights, bias)
ROW_CASES = [("2d_i8_bias_22", "22", (8, D_IN), "float32", False, True),
             ("3d_i8_22", "22", (4, 6, D_IN), "float32", False, False),
             ("3d_pk_bias_22", "22", (4, 6, D_IN), "float32", True, True),
             ("2d_pk_22", "22", (8, D_IN), "float32", True, False),
             ("3d_bf16_bias_22", "22", (4, 6, D_IN), "bfloat16", False, True),
             ("2d_i8_bias_4", "4", (8, D_IN), "float32", False, True),
             ("3d_pk_4", "4", (4, 6, D_IN), "float32", True, False),
             ("3d_bf16_pk_bias_4", "4", (4, 6, D_IN), "bfloat16", True,
              True)]
LM_BATCH, LM_PROMPT, LM_STEPS, LM_MAX_LEN = 4, 16, 4, 24
A2A_E, A2A_K, A2A_CF, A2A_D, A2A_FF, A2A_T = 8, 2, 8.0, 32, 64, 64
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_D = 4, 8, 2, 16
ELASTIC_LM = dict(name="t", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
                  d_ff=64, vocab=64, dtype="float32", remat=False)
# partitioned ring serving: SMOKE configs, int8 ("w8") and packed int4
# ("w4p") weights, kv 8 and 4, on (data, model) meshes of 4 ranks; the
# torch backend too on one mesh, and there two in bf16, their trees from
# partition.build_params (seed 0) on each rank
PART_ARCHS = ("qwen2.5-32b", "yi-34b", "llama4-scout-17b-a16e",
              "phi3.5-moe-42b-a6.6b")
PART_WEIGHTS = {"w8": (8, False), "w4p": (4, True)}
PART_KV = (8, 4)
PART_MESHES = ((1, 4), (2, 2), (4, 1))
PART_TORCH_MESH = (2, 2)
PART_BF16 = ("qwen2.5-32b", "llama4-scout-17b-a16e")
PART_BATCH, PART_PROMPT, PART_STEPS, PART_MAX_LEN = 4, 32, 4, 40
# decode steps from JAX's prefill cache, carried into each rank's shard
PART_FROM_JAX = (("w8", 8), ("w4p", 4))
# partitioned ring serving of the recurrent and encoder-decoder families:
# their SMOKE configs, the weights and kv bits above, on the same meshes;
# prompts of 32 fill RecurrentGemma's 32-slot local ring (window 16 +
# q_chunk 16), so its steps wrap; Whisper hears 16 stub frames a row
FAM_ARCHS = ("recurrentgemma-9b", "mamba2-130m", "whisper-large-v3")
# partitioned training (tests/test_torch_partition_train.py): the reference's
# train cell (launch/dryrun.py: value_and_grad(lm_loss), LAMB, fake
# w4/a8/attn7) on the SMOKE configs of Qwen2.5-32B (two loss chunks) and
# Llama-4-Scout (recomputed units), and float mode at
# tests/test_distributed.py's widths; f32, one step on 8 x 32 tokens (two
# query chunks); warm-up of one step, so the update is lr 5e-4's
TRAIN_CASES = ("qwen-fake", "llama-fake", "qwen-float")
TRAIN_MESHES = ((2, 2), (1, 4), (4, 1))
TRAIN_BATCH, TRAIN_SEQ = 8, 32
TRAIN_FLOAT_LM = dict(name="t", n_layers=2, d_model=32, n_heads=4,
                      kv_heads=2, d_ff=64, vocab=64, dtype="float32",
                      q_chunk=16, remat=False)
TRAIN_OPT = dict(total_steps=100, warmup_steps=1)
# the trained tree integerized (int8 weights, kv 8) and served partitioned
TRAIN_SERVE = dict(w_bits=8, a_bits=8, attn_bits=7, kv_bits=8, mode="int")
TRAIN_SERVE_STEPS, TRAIN_SERVE_PROMPT = 4, 16
# partitioned training of the families
# (tests/test_torch_partition_train_families.py), the same cell, meshes,
# batch and step: RecurrentGemma-9B SMOKE cut to 3 layers (one (rglru,
# rglru, local) unit: the RG-LRU split by d_rnn, its one KV head whole),
# Mamba2-130M SMOKE cut to 1 layer (the SSD mixer whole), both recomputed
# as the reference's cell sets ``remat``, and Whisper SMOKE (2 + 2 layers,
# 4 heads, 16 stub frames a row; no remat, as in the cell); fake
# w4/a8/attn7, and RecurrentGemma in float mode too
FAM_TRAIN_CASES = ("rg-fake", "mamba-fake", "whisper-fake", "rg-float")
FAM_TRAIN_ARCH = {"rg": ("recurrentgemma-9b", dict(n_layers=3, remat=True)),
                  "mamba": ("mamba2-130m", dict(n_layers=1, remat=True)),
                  "whisper": ("whisper-large-v3", {})}


def train_config(case, lm_mod, registry, quant_config):
    """One training case's config (an LMConfig, or Whisper's EncDecConfig)
    in either package (its ``lm`` module, registry and QuantConfig
    class)."""
    if case == "qwen-float":
        return lm_mod.LMConfig(**TRAIN_FLOAT_LM)
    fq = quant_config(w_bits=4, a_bits=8, attn_bits=7, mode="fake")
    model, mode = case.split("-")
    if model in FAM_TRAIN_ARCH:
        arch, kw = FAM_TRAIN_ARCH[model]
        return registry.smoke_config(arch).replace(
            quant=fq if mode == "fake" else None, **kw)
    if case == "qwen-fake":
        return registry.smoke_config("qwen2.5-32b").replace(
            quant=fq, loss_chunk=16)
    return registry.smoke_config("llama4-scout-17b-a16e").replace(
        quant=fq, remat=True)


def train_batch(case, cfg):
    """A case's tokens and labels (TRAIN_BATCH x TRAIN_SEQ), and Whisper's
    stub frames, from a seed of the case's name."""
    rs = np.random.RandomState(sum(map(ord, case)))
    out = {k: rs.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(
        np.int32) for k in ("tokens", "labels")}
    if hasattr(cfg, "n_enc_layers"):
        out["frames"] = rs.randn(TRAIN_BATCH, cfg.n_audio_ctx,
                                 cfg.d_model).astype(np.float32)
    return out


def batch_of(ref, case):
    """A case's saved batch (:func:`train_batch`) as CPU tensors."""
    import torch
    pre = f"{case}/batch/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(pre)}


def part_quant(weights, kv_bits):
    """QuantConfig fields of a partitioned case (either package's)."""
    w_bits, packed = PART_WEIGHTS[weights]
    return dict(w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                mode="int", pack_weights=packed)


def part_cases():
    """(arch, weights, kv_bits, mesh, backend, dtype) of every partitioned
    run."""
    return [(arch, w, kv, mesh, backend, "float32")
            for mesh in PART_MESHES for arch in PART_ARCHS
            for w in PART_WEIGHTS for kv in PART_KV
            for backend in ("cuda", "torch")
            if backend == "cuda" or mesh == PART_TORCH_MESH] + \
        [(arch, "w4p", 8, PART_TORCH_MESH, "cuda", "bfloat16")
         for arch in PART_BF16]


def fam_cases():
    """(arch, weights, kv_bits, mesh) of every partitioned family run, on
    the ``cuda`` backend (the kernels' plain versions on the CPU)."""
    return [(arch, w, kv, mesh) for mesh in PART_MESHES for arch in FAM_ARCHS
            for w in PART_WEIGHTS for kv in PART_KV]


def fam_key(case):
    arch, w, kv, mesh = case
    return f"{arch}/{w}/kv{kv}/{mesh_tag(mesh)}"


def fam_batch(arrays, arch):
    """The prompts of a family run, and Whisper's frames, as tensors."""
    import torch
    batch = {"tokens": torch.from_numpy(np.array(arrays["tokens"]))}
    if arch == "whisper-large-v3":
        batch["frames"] = torch.from_numpy(np.array(arrays["frames"]))
    return batch


def part_key(case):
    arch, w, kv, mesh, backend, dtype = case
    return f"{arch}/{w}/kv{kv}/{mesh_tag(mesh)}/{backend}/{dtype}"


def mesh_tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def model_of(cfg):
    """The port's model module that serves ``cfg``."""
    from repro_torch.configs.registry import is_encdec
    from repro_torch.models import encdec, lm
    return encdec if is_encdec(cfg) else lm


def greedy_from(params, cache, token, cfg):
    """PART_STEPS free-running greedy ring steps from ``cache``, fed
    ``token`` (B, 1) first: (logits (steps, B, 1, V), fed (steps, B, 1))."""
    import torch

    model = model_of(cfg)
    out, fed = [], [token]
    for i in range(PART_STEPS):
        logits, cache = model.decode_step(params, fed[-1], cache, cfg)
        out.append(logits)
        if i + 1 < PART_STEPS:
            fed.append(torch.argmax(logits[:, -1], -1).to(torch.int32)
                       [:, None])
    return torch.stack(out), torch.stack(fed)


def greedy(params, tokens, cfg, steps=PART_STEPS, max_len=PART_MAX_LEN):
    """The port's ring prefill and ``steps`` free-running greedy decode
    steps: (logits (steps + 1, B, 1, V), fed tokens (steps, B, 1),
    cache).  ``tokens``: the prompts, or Whisper's batch (``frames`` and
    ``tokens``)."""
    import torch

    model = model_of(cfg)
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    logits, cache = model.prefill(params, batch, cfg, max_len)
    out, fed = [logits], []
    for _ in range(steps):
        fed.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        logits, cache = model.decode_step(params, fed[-1], cache, cfg)
        out.append(logits)
    return torch.stack(out), torch.stack(fed), cache


def flat(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflat(d, prefix):
    """The inverse of :func:`flat` for the keys under ``prefix``."""
    out = {}
    for key, v in d.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def save(path, arrays):
    """numpy / jax arrays -> npz; bfloat16 widened under "@bf16" keys."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            out[k + "@bf16"] = a.astype(np.float32)
        else:
            out[k] = a
    np.savez(path, **out)


def load(path):
    """npz -> {key: numpy array}; "@bf16" keys stay widened, key kept."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

# the shard bodies on rank-local operands
# (tests/test_torch_partition_shard_bodies.py): the row-parallel body at
# Qwen2.5 SMOKE's down (K = d_ff 128, 2-D x) and wo (K = 4 heads x 16, 3-D
# x) widths into d_model 64, int8 and packed, on (data, model) meshes of
# 2 and 4 ranks (a mesh of 2 runs twice over an outer axis "x"); the MoE
# FFN of layer 0 of Llama-4-Scout's and Phi-3.5-MoE's SMOKE trees on 64
# tokens, and 2 decode-sized ones (one a batch rank: the dense dispatch);
# the reference test's float a2a with gradients in float and fake mode;
# one train step of Llama-4-Scout SMOKE in float and fake mode; greedy
# serving of Qwen2.5 and Llama-4-Scout SMOKE under the reference's "opt"
# rules (both options, packed int4 weights); one int forward of
# RecurrentGemma-9B and Whisper SMOKE under int_bf16_reduce at (1, 2)
SB_ROW_MESHES = ((1, 2), (1, 4), (2, 2))
SB_ROW_CASES = (("2d_i8", (16, 128), False), ("2d_pk", (16, 128), True),
                ("3d_i8", (4, 8, 64), False), ("3d_pk", (4, 8, 64), True))
SB_ROW_N = 64
SB_MOE_ARCHS = ("llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b")
SB_MOE_T, SB_MOE_DECODE_T = 64, 2
SB_RULES = {"bf16red": dict(int_bf16_reduce=True),
            "a2a": dict(moe_a2a=True),
            "opt": dict(int_bf16_reduce=True, moe_a2a=True)}
SB_W = {"bf16red": "w8", "a2a": "w8", "opt": "w4p"}
SB_GREEDY_ARCHS = ("qwen2.5-32b", "llama4-scout-17b-a16e")
SB_BATCH, SB_PROMPT, SB_STEPS = 4, 16, 8
SB_LOCAL_ARCHS = ("qwen2.5-32b", "chatglm3-6b", "llama4-scout-17b-a16e",
                  "phi3.5-moe-42b-a6.6b")
SB_LOCAL_MESHES = ((1, 4), (2, 2))
SB_LOCAL_STEPS = 4
SB_FAM_ARCHS = ("recurrentgemma-9b", "whisper-large-v3")
SB_FAM_MESH = (1, 2)
SB_TRAIN_CASES = ("llama-fake", "llama-float")
SB_TRAIN_MESH = (2, 2)


def sb_quant(rules_tag):
    """QuantConfig fields of a shard-body serving case: int8 weights, or
    the "opt" rules' packed int4; kv 8."""
    return part_quant(SB_W[rules_tag], 8)


def sb_row_inputs(name, shape, packed):
    rng = np.random.RandomState(sum(map(ord, name)) + 7)
    x = rng.randn(*shape).astype(np.float32)
    k = shape[-1]
    w = (rng.randn(k, SB_ROW_N) * k ** -0.5).astype(np.float32)
    b = (rng.randn(SB_ROW_N) * 0.1).astype(np.float32) \
        if len(shape) == 2 else None
    return x, w, b


def sb_train_config(case, lm_mod, registry, quant_config):
    """Llama-4-Scout SMOKE as ``train_config("llama-fake")`` gives it, in
    fake or float mode."""
    cfg = train_config("llama-fake", lm_mod, registry, quant_config)
    return cfg if case.endswith("fake") else cfg.replace(quant=None)


def jax_shard_bodies(out_path, which):
    """The reference's two shard bodies on host meshes of 2 and 4 devices
    (``jax.sharding.Mesh``, the caller's 8 host devices), and the inputs
    it made: see the SB_* constants.  ``which``: "bodies" (the row-parallel
    body, the MoE FFN, the a2a gradients), "serve" (greedy serving, the
    families' forwards) or "train" (the train steps), which the caller runs
    side by side."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())

    def mesh_of(shape):
        return Mesh(devs[:shape[0] * shape[1]].reshape(shape),
                    ("data", "model"))
    res = {}

    {"bodies": _jax_bodies, "serve": _jax_serve,
     "train": _jax_train}[which](res, mesh_of)
    save(out_path, res)


def _jax_bodies(res, mesh_of):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP

    from repro.configs.registry import smoke_config
    from repro.core import quant as jquant
    from repro.core.api import QuantConfig, dense, integerize_params
    from repro.distributed.sharding import Rules, use_rules
    from repro.layers import moe
    from repro.models import lm

    # the row-parallel body alone (compiled, every case of a mesh in one
    # program: an eager shard_map runs op by op), and each rank's
    # activation codes and int32 sums from the same ops in a shard_map
    for shape in SB_ROW_MESHES:
        mesh = mesh_of(shape)
        progs, args = [], []
        for name, xshape, packed in SB_ROW_CASES:
            x, w, b = sb_row_inputs(name, xshape, packed)
            qc = QuantConfig(w_bits=4, a_bits=8, mode="int",
                             pack_weights=packed)
            lin = {"w": jnp.asarray(w)}
            if b is not None:
                lin["b"] = jnp.asarray(b)
            p = integerize_params({"wo": lin}, qc)["wo"]
            w_q = p["w_q"]
            if w_q.dtype == jnp.uint8:
                w_q = jquant.unpack_int4(w_q)

            def f(xl, wq):
                xq = jquant.quantize_tensor(xl, qc.a_bits)
                acc = jnp.matmul(xq.q, wq.T,
                                 preferred_element_type=jnp.int32)
                return xq.q[None], acc[None]
            nd = len(xshape)
            xspec = JP(*(["data"] + [None] * (nd - 2) + ["model"]))
            ospec = JP(("data", "model"))
            parts = shard_map(f, mesh=mesh, in_specs=(xspec, JP(
                None, "model")), out_specs=(ospec, ospec), check_rep=False)
            progs.append((parts, qc))
            args.append((jnp.asarray(x), p, w_q))
            res.update(flat({"x": x, "p": p},
                            f"row/{name}/{mesh_tag(shape)}/"))

        def run(args):
            return [(dense(x, p, qc, tp="row"), parts(x, w_q))
                    for (parts, qc), (x, p, w_q) in zip(progs, args)]
        with mesh, use_rules(Rules(batch=("data",), mesh=mesh,
                                   int_bf16_reduce=True)):
            outs = jax.jit(run)(args)
        for (name, _, _), (y, (codes, acc)) in zip(SB_ROW_CASES, outs):
            res.update(flat({"y": y, "codes": codes, "acc": acc},
                            f"row/{name}/{mesh_tag(shape)}/"))

    mesh = mesh_of((2, 2))
    opt = Rules(batch=("data",), mesh=mesh, **SB_RULES["opt"])
    rs = np.random.RandomState(9)
    for arch in SB_MOE_ARCHS:
        qc = QuantConfig(**sb_quant("a2a"))
        cfg = smoke_config(arch).replace(quant=qc)
        params = jax.jit(lambda k: integerize_params(
            lm.init_params(k, cfg.replace(quant=None)), qc))(
                jax.random.PRNGKey(0))
        res.update(flat(params, f"{arch}/a2a/params/"))
        p0 = jax.tree.map(lambda a: a[0], params["units"]["b0"]["ffn"])
        x = rs.randn(SB_MOE_T, cfg.d_model).astype(np.float32)
        with mesh, use_rules(opt):
            y, aux = jax.jit(lambda x, p: moe.moe_ffn(
                x, p, cfg.moe, cfg.quant, act=cfg.act))(x, p0)
        res.update(flat({"x": x, "y": y, "lb": aux["lb_loss"]},
                        f"{arch}/moe/"))
        res[f"{arch}/decode/x"] = rs.randn(
            SB_MOE_DECODE_T, cfg.d_model).astype(np.float32)

    # the reference test's a2a (8 experts, top-2) with gradients of
    # sum(y ** 2) + lb_loss, float and fake
    mcfg = moe.MoEConfig(n_experts=A2A_E, top_k=A2A_K,
                         capacity_factor=A2A_CF)
    p = moe.init_moe(jax.random.PRNGKey(0), A2A_D, A2A_FF, mcfg,
                     dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (A2A_T, A2A_D))
    res.update(flat({"p": p, "x": x}, "a2a/"))
    for mode in ("float", "fake"):
        qc = None if mode == "float" else QuantConfig(w_bits=4, a_bits=8,
                                                      mode="fake")
        for fsdp in (False, True):
            rules = Rules(batch=("data",), mesh=mesh, moe_a2a=True,
                          expert_fsdp=fsdp)

            def loss(p):
                y, aux = moe.moe_ffn(x, p, mcfg, qc)
                return jnp.sum(y ** 2) + aux["lb_loss"], (y, aux["lb_loss"])
            with mesh, use_rules(rules):
                (_, (y, lb)), g = jax.jit(jax.value_and_grad(
                    loss, has_aux=True))(p)
            res.update(flat({"y": y, "lb": lb, "grad": g},
                            f"a2a/{mode}/fsdp{int(fsdp)}/"))


def _jax_serve(res, mesh_of):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import smoke_config
    from repro.core.api import QuantConfig, integerize_params
    from repro.distributed.sharding import Rules, use_rules
    from repro.models import encdec, lm

    mesh = mesh_of((2, 2))
    opt = Rules(batch=("data",), mesh=mesh, **SB_RULES["opt"])

    # greedy serving under the "opt" rules
    def int_tree(arch, qc, seed=0):
        cfg = smoke_config(arch).replace(quant=qc)
        return cfg, jax.jit(lambda k: integerize_params(
            lm.init_params(k, cfg.replace(quant=None)), qc))(
                jax.random.PRNGKey(seed))
    toks = np.random.RandomState(5).randint(
        0, 512, (SB_BATCH, SB_PROMPT)).astype(np.int32)
    res["tokens"] = toks
    for arch in SB_GREEDY_ARCHS:
        cfg, params = int_tree(arch, QuantConfig(**sb_quant("opt")))
        res.update(flat(params, f"{arch}/opt/params/"))
        with mesh, use_rules(opt):
            prefill = jax.jit(lambda p, b: lm.prefill(
                p, b, cfg, SB_PROMPT + SB_STEPS))
            step = jax.jit(lambda p, t, c: lm.decode_step(p, t, c, cfg))
            logits, cache = prefill(params, {"tokens": toks})
            out, fed = [logits], []
            for _ in range(SB_STEPS):
                fed.append(jnp.argmax(logits[:, -1], -1).astype(
                    jnp.int32)[:, None])
                logits, cache = step(params, fed[-1], cache)
                out.append(logits)
        res[f"{arch}/opt/logits"] = np.stack([np.asarray(t) for t in out])
        res[f"{arch}/opt/fed"] = np.stack([np.asarray(t) for t in fed])

    # one int forward of the families under int_bf16_reduce at (1, 2)
    mesh = mesh_of(SB_FAM_MESH)
    rules = Rules(batch=("data",), mesh=mesh, int_bf16_reduce=True)
    for arch in SB_FAM_ARCHS:
        qc = QuantConfig(**sb_quant("bf16red"))
        cfg = smoke_config(arch).replace(quant=qc)
        mod = encdec if arch.startswith("whisper") else lm
        params = jax.jit(lambda k: integerize_params(
            mod.init_params(k, cfg.replace(quant=None)), qc))(
                jax.random.PRNGKey(0))
        batch = {"tokens": toks % cfg.vocab}
        rs = np.random.RandomState(13)
        if mod is encdec:
            batch["frames"] = rs.randn(SB_BATCH, cfg.n_audio_ctx,
                                       cfg.d_model).astype(np.float32)
        with mesh, use_rules(rules):
            logits, _ = jax.jit(lambda p, b: mod.prefill(
                p, b, cfg, SB_PROMPT))(params, batch)
        res.update(flat({"params": params, "batch": batch,
                         "logits": logits}, f"{arch}/bf16red/"))



def _jax_train(res, mesh_of):
    import jax

    from repro.configs import registry
    from repro.core.api import QuantConfig
    from repro.distributed.sharding import Rules, use_rules
    from repro.models import lm
    from repro.optim import OptConfig, init_opt_state, opt_update

    mesh = mesh_of((2, 2))
    # one train step of the train cell with moe_a2a and expert_fsdp
    rules = Rules(batch=("data",), mesh=mesh, moe_a2a=True,
                  expert_fsdp=True)
    for case in SB_TRAIN_CASES:
        cfg = sb_train_config(case, lm, registry, QuantConfig)
        params = jax.jit(lambda k: lm.init_params(k, cfg))(
            jax.random.PRNGKey(0))
        batch = train_batch("llama-fake", cfg)
        ocfg = OptConfig(**TRAIN_OPT)

        def tstep(p, o, b):
            (loss, _), g = jax.value_and_grad(
                lambda p, b: lm.lm_loss(p, b, cfg), has_aux=True)(p, b)
            p, o, om = opt_update(p, g, o, ocfg)
            return loss, g, p, om["grad_norm"]
        with mesh, use_rules(rules):
            loss, g, new, gnorm = jax.jit(tstep)(
                params, init_opt_state(params), batch)
        res.update(flat({"params": params, "batch": batch, "loss": loss,
                         "grads": g, "new": new, "grad_norm": gnorm},
                        f"{case}/"))


def row_inputs(case):
    name, _, shape, dtype, packed, bias = case
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(D_IN, D_OUT) * D_IN ** -0.5).astype(np.float32)
    b = (rng.randn(D_OUT) * 0.1).astype(np.float32) if bias else None
    return x, w, b


def jax_reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from repro.configs.registry import smoke_config
    from repro.core.api import QuantConfig, dense, integerize_params
    from repro.distributed.compression import compress_psum
    from repro.distributed.elastic import best_mesh, reshard_to
    from repro.distributed.pipeline import pipeline_forward
    from repro.distributed.sharding import Rules, use_rules
    from repro.layers import moe
    from repro.models import lm

    devs = np.array(jax.devices()[:4])
    meshes = {"22": Mesh(devs.reshape(2, 2), ("data", "model")),
              "4": Mesh(devs, ("model",))}
    res = {}

    # the row-parallel integer linear, alone
    for case in ROW_CASES:
        name, mesh, _, dtype, packed, bias = case
        x, w, b = row_inputs(case)
        qc = QuantConfig(w_bits=4, a_bits=8, mode="int", pack_weights=packed)
        lin = {"w": jnp.asarray(w)}
        if b is not None:
            lin["b"] = jnp.asarray(b, dtype)
        p = integerize_params({"wo": lin}, qc)["wo"]
        xj = jnp.asarray(x, dtype)
        rules = Rules(batch=("data",), mesh=meshes[mesh],
                      int_bf16_reduce=True)
        with meshes[mesh], use_rules(rules):
            # eager, op by op, and compiled: XLA's compiled epilogue reads
            # a bf16 activation scale unrounded (excess precision)
            y = dense(xj, p, qc, tp="row")
            yc = jax.jit(lambda x, p: dense(x, p, qc, tp="row"))(xj, p)
        res.update(flat({"x": xj, "p": p, "y": y, "y_jit": yc},
                        f"row/{name}/"))

    # integer LM prefill + ring decode, and the MoE forward, on the mesh
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int")
    rules = Rules(batch=("data",), mesh=meshes["22"], int_bf16_reduce=True,
                  moe_a2a=True)
    for arch, tag in (("qwen2.5-32b", "qwen"), ("phi3.5-moe-42b-a6.6b",
                                                "moe")):
        cfg = smoke_config(arch).replace(quant=qc)
        params = jax.jit(lambda k: integerize_params(
            lm.init_params(k, cfg.replace(quant=None)), qc))(
                jax.random.PRNGKey(0))
        toks = np.random.RandomState(1).randint(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
        res.update(flat(params, f"{tag}/params/"))
        res[f"{tag}/tokens"] = toks
        with meshes["22"], use_rules(rules):
            if tag == "qwen":
                logits, cache = jax.jit(lambda p, b: lm.prefill(
                    p, b, cfg, LM_MAX_LEN))(params, {"tokens": toks})
                step = jax.jit(lambda p, t, c: lm.decode_step(p, t, c, cfg))
                fed = []
                for i in range(LM_STEPS + 1):
                    res[f"qwen/logits{i}"] = logits
                    if i == LM_STEPS:
                        break
                    fed.append(np.asarray(jnp.argmax(logits[:, -1], -1),
                                          np.int32)[:, None])
                    logits, cache = step(params, fed[-1], cache)
                res["qwen/fed"] = np.stack(fed)
            else:
                def fwd(p, b):
                    x, _, aux = lm.forward(p, b, cfg)
                    return lm.logits_fn(p, x, cfg), aux
                logits, aux = jax.jit(fwd)(params, {"tokens": toks})
                res["moe/logits"], res["moe/aux"] = logits, aux

    # the reference test's float a2a, with gradients
    mcfg = moe.MoEConfig(n_experts=A2A_E, top_k=A2A_K,
                         capacity_factor=A2A_CF)
    p = moe.init_moe(jax.random.PRNGKey(0), A2A_D, A2A_FF, mcfg,
                     dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (A2A_T, A2A_D))
    y_dense, aux_dense = moe.moe_ffn(x, p, mcfg, None)
    res.update(flat({"p": p, "x": x, "y_dense": y_dense}, "a2a/"))
    qc = QuantConfig(w_bits=4, a_bits=8, mode="int")
    pq = integerize_params(p, qc)
    res.update(flat(pq, "a2a/pq/"))
    for fsdp in (False, True):
        rules = Rules(batch=("data",), mesh=meshes["22"], moe_a2a=True,
                      expert_fsdp=fsdp)
        with meshes["22"], use_rules(rules):
            y, aux = jax.jit(lambda x, p: moe.moe_ffn(x, p, mcfg, None))(x, p)
            g = jax.jit(jax.grad(lambda p: jnp.sum(
                moe.moe_ffn(x, p, mcfg, None)[0] ** 2)))(p)
            yq, _ = jax.jit(lambda x, p: moe.moe_ffn(x, p, mcfg, qc))(x, pq)
        res.update(flat({"y": y, "lb": aux["lb_loss"], "grad": g, "yq": yq},
                        f"a2a/fsdp{int(fsdp)}/"))

    # compress_psum over 4 data ranks, one leaf per dtype
    mesh = Mesh(devs, ("data",))
    rng = np.random.RandomState(3)
    grads = {"w": rng.randn(4, 64).astype(np.float32),
             "v": (rng.randn(4, 3, 8) * 3).astype(np.float32)}
    err = {"w": np.zeros((4, 64), np.float32),
           "v": (rng.randn(4, 3, 8) * 0.01).astype(np.float32)}

    def f(gs, es):
        out, new = compress_psum({k: v[0] for k, v in gs.items()},
                                 {k: v[0] for k, v in es.items()},
                                 ("data",), bits=8)
        return ({k: v[None] for k, v in out.items()},
                {k: v[None] for k, v in new.items()})
    fm = shard_map(f, mesh=mesh, in_specs=(JP("data"), JP("data")),
                   out_specs=(JP("data"), JP("data")), check_rep=False)
    mean, new_err = jax.jit(fm)(grads, err)
    res.update(flat({"g": grads, "e": err, "mean": mean, "err": new_err},
                    "psum/"))

    # GPipe over 4 stages
    mesh = Mesh(devs, ("stage",))
    ws = jax.random.normal(jax.random.PRNGKey(0),
                           (PIPE_STAGES, PIPE_D, PIPE_D)) * 0.3
    xs = jax.random.normal(jax.random.PRNGKey(1),
                           (PIPE_MICRO, PIPE_MB, PIPE_D))
    out = pipeline_forward(lambda w, x: jnp.tanh(x @ w), ws, xs, mesh,
                           axis="stage")
    res.update({"pipe/ws": ws, "pipe/xs": xs, "pipe/out": out})

    # elastic: 8 devices -> 6, each leaf's shard shape
    cfg = lm.LMConfig(**ELASTIC_LM)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    res.update(flat(params, "elastic/params/"))
    tree = params
    for n in (8, 6):
        m = best_mesh(n)
        tree = reshard_to(jax.device_get(tree), m)
        res[f"elastic/mesh{n}"] = np.asarray(m.devices.shape)
        res.update(flat(jax.tree.map(
            lambda a: np.asarray(a.sharding.shard_shape(a.shape)), tree),
            f"elastic/shard{n}/"))
    save(out_path, res)


def jax_train(ref_path, out_path):
    """The reference's train cell on a (data 2, model 2) host mesh, as
    ``launch/dryrun.py`` builds it: ``param_specs(expert_fsdp=True)`` for
    the params, ``zero1_specs`` for ``mu`` / ``nu``, the batch over
    "data"; per case the loss, gradients, updated params and gradient
    norm, and the shard shapes of the moments and the experts."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import registry
    from repro.core.api import QuantConfig
    from repro.distributed.sharding import (Rules, batch_specs,
                                            enforce_divisible,
                                            filter_mesh_axes,
                                            named_shardings, param_specs,
                                            use_rules, zero1_specs)
    from repro.models import lm
    from repro.optim import OptConfig, init_opt_state, opt_update

    ref = load(ref_path)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

    def finalize(specs, tree):
        return named_shardings(enforce_divisible(
            filter_mesh_axes(specs, mesh), tree, mesh), mesh)

    res = {}
    for case in TRAIN_CASES:
        cfg = train_config(case, lm, registry, QuantConfig)
        params = unflat({k: v for k, v in ref.items()}, f"{case}/params")
        batch = {k: ref[f"{case}/batch/{k}"] for k in ("tokens", "labels")}
        opt = init_opt_state(params)
        ocfg = OptConfig(**TRAIN_OPT)

        def step(p, o, b):
            (loss, _), g = jax.value_and_grad(
                lambda p, b: lm.lm_loss(p, b, cfg), has_aux=True)(p, b)
            p, o, om = opt_update(p, g, o, ocfg)
            return loss, g, p, om["grad_norm"]

        pspecs = param_specs(params, expert_fsdp=True)
        ospecs = {"mu": zero1_specs(opt["mu"], pspecs, data_size=2),
                  "nu": zero1_specs(opt["nu"], pspecs, data_size=2),
                  "step": jax.sharding.PartitionSpec()}
        in_sh = (finalize(pspecs, params), finalize(ospecs, opt),
                 finalize(batch_specs(batch, ("data",)), batch))
        with mesh, use_rules(Rules(batch=("data",))):
            loss, g, new, gnorm = jax.jit(step, in_shardings=in_sh)(
                params, opt, batch)
        res.update(flat({"loss": loss, "grads": g, "params": new,
                         "grad_norm": gnorm}, f"{case}/"))
        res.update(flat(jax.tree.map(
            lambda sh, a: np.asarray(sh.shard_shape(a.shape)),
            {"mu": in_sh[1]["mu"], "params": in_sh[0]},
            {"mu": opt["mu"], "params": params}), f"{case}/shard/"))
    save(out_path, res)


# ---------------------------------------------------------------------------
# The port, one gloo rank
# ---------------------------------------------------------------------------

def _tensors(ref, prefix):
    """The reference's arrays under ``prefix`` as the port's CPU tensors."""
    import torch
    out = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            t = torch.from_numpy(np.array(v))
            if k.endswith("@bf16"):
                t, k = t.to(torch.bfloat16), k[:-5]
            out[k] = t
    return out


def _tree(ref, prefix):
    return unflat(_tensors(ref, prefix + "/"), prefix)


def _np(tree):
    import torch
    return {k: (v.detach().float() if v.dtype == torch.bfloat16
                else v.detach()).numpy() for k, v in flat(tree).items()}


def main_job(rank, world, ref):
    import torch

    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, dense
    from repro_torch.distributed.compression import compress_psum
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.layers import moe
    from repro_torch.models import lm

    meshes = {"22": make_test_mesh((2, 2), ("data", "model"),
                                   device_type="cpu"),
              "4": make_test_mesh((4,), ("model",), device_type="cpu"),
              # every rank alone on its "data" and "model" axes
              "solo": make_test_mesh((4, 1, 1), ("x", "data", "model"),
                                     device_type="cpu")}
    out = {}

    for name, mesh, _, dtype, packed, bias in ROW_CASES:
        x = _tensors(ref, f"row/{name}/x")[f"row/{name}/x"]
        p = _tree(ref, f"row/{name}/p")
        qc = QuantConfig(w_bits=4, a_bits=8, mode="int")
        for m in (mesh, "solo"):
            rules = Rules(batch=("data",), mesh=meshes[m],
                          int_bf16_reduce=True)
            for backend in ("cuda", "torch"):
                dispatch.reset_stats()
                with use_rules(rules), dispatch.use_backend(backend):
                    y = dense(x, p, qc, tp="row")
                key = f"row/{name}/{m}/{backend}"
                out[key] = y
                out[key + "/calls"] = torch.tensor(
                    dispatch.STATS[f"qlinear_row_{backend}"])

    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int")
    rules = Rules(batch=("data",), mesh=meshes["22"], int_bf16_reduce=True,
                  moe_a2a=True)
    cfg = smoke_config("qwen2.5-32b").replace(quant=qc)
    params = _tree(ref, "qwen/params")
    toks = _tensors(ref, "qwen/tokens")["qwen/tokens"]
    fed = _tensors(ref, "qwen/fed")["qwen/fed"]
    dispatch.reset_stats()
    with use_rules(rules):
        logits, cache = lm.prefill(params, {"tokens": toks}, cfg, LM_MAX_LEN)
        out["qwen/logits0"] = logits
        for i in range(LM_STEPS):
            logits, cache = lm.decode_step(params, fed[i], cache, cfg)
            out[f"qwen/logits{i + 1}"] = logits
    out["qwen/row_calls"] = torch.tensor(dispatch.STATS["qlinear_row_cuda"])
    out["qwen/plain_calls"] = torch.tensor(
        dispatch.STATS["qlinear_row_torch"] + dispatch.STATS["qlinear_torch"])

    cfg = smoke_config("phi3.5-moe-42b-a6.6b").replace(quant=qc)
    params = _tree(ref, "moe/params")
    toks = _tensors(ref, "moe/tokens")["moe/tokens"]
    dispatch.reset_stats()
    with use_rules(rules):
        x, _, aux = lm.forward(params, {"tokens": toks}, cfg)
        out["moe/logits"] = lm.logits_fn(params, x, cfg)
    out["moe/aux"] = aux
    out["moe/qexpert_calls"] = torch.tensor(dispatch.STATS["qexpert_cuda"])

    mcfg = moe.MoEConfig(n_experts=A2A_E, top_k=A2A_K,
                         capacity_factor=A2A_CF)
    x = _tensors(ref, "a2a/x")["a2a/x"]
    pq = _tree(ref, "a2a/pq")
    qc = QuantConfig(w_bits=4, a_bits=8, mode="int")
    for fsdp in (False, True):
        p = _tree(ref, "a2a/p")
        for leaf in flat(p).values():
            leaf.requires_grad_(True)
        rules = Rules(batch=("data",), mesh=meshes["22"], moe_a2a=True,
                      expert_fsdp=fsdp)
        with use_rules(rules):
            y, aux = moe.moe_ffn(x, p, mcfg, None)
            (y ** 2).sum().backward()
            with torch.no_grad():
                yq, _ = moe.moe_ffn(x, pq, mcfg, qc)
        tag = f"a2a/fsdp{int(fsdp)}"
        out.update({f"{tag}/grad/{k}": leaf.grad
                    for k, leaf in flat(p).items()})
        out.update({f"{tag}/y": y, f"{tag}/lb": aux["lb_loss"],
                    f"{tag}/yq": yq})

    mesh = make_test_mesh((4,), ("data",), device_type="cpu")
    g = {k: v[rank] for k, v in _tree(ref, "psum/g").items()}
    e = {k: v[rank] for k, v in _tree(ref, "psum/e").items()}
    mean, new_err = compress_psum(g, e, ("data",), mesh=mesh, bits=8)
    out.update(flat({"mean": mean, "err": new_err}, "psum/"))

    mesh = make_test_mesh((4,), ("stage",), device_type="cpu")
    ws = _tensors(ref, "pipe/ws")["pipe/ws"]
    xs = _tensors(ref, "pipe/xs")["pipe/xs"]
    out["pipe/out"] = pipeline_forward(lambda w, x: torch.tanh(x @ w), ws, xs,
                                       mesh, axis="stage")
    return out


# ---------------------------------------------------------------------------
# The shard bodies on rank-local operands
# ---------------------------------------------------------------------------

def sb_mesh(shape):
    """A (data, model) mesh of ``shape`` over the 4 ranks: under an outer
    axis "x" (which no rule reads) where it holds fewer, so each x slice
    runs it alone."""
    from repro_torch.launch.mesh import make_test_mesh
    n = shape[0] * shape[1]
    if n == 4:
        return make_mesh(shape)
    return make_test_mesh((4 // n, *shape), ("x", "data", "model"),
                          device_type="cpu")


def _sb_counts(prefix):
    """The dispatch counts a shard-body run is held by."""
    import torch

    from repro_torch.kernels import dispatch
    st = dispatch.STATS
    return {f"{prefix}/{k}": torch.tensor(st[k]) for k in (
        "qlinear_row_cuda", "qlinear_acc_cuda", "qlinear_row_torch",
        "qlinear_acc_torch", "qlinear_torch", "qexpert_cuda",
        "qexpert_torch")}


def _row_memos(tree):
    from repro_torch import tree as tree_lib
    return sum("_row_codes" in (t if t._base is None else t._base).__dict__
               for t in tree_lib.leaves(tree))


def shard_local_job(rank):
    """The shard bodies on the rank's tree (``partition.build_params``)
    against the same bodies on the global tree, under the same rules on
    the same mesh: SB_LOCAL_ARCHS, prefill and SB_LOCAL_STEPS greedy ring
    steps, each rules set of SB_RULES that the arch runs; the dispatch
    counts, the all-to-all body's calls and the ``_row_codes`` memos of
    the local trees."""
    import torch

    from chip_smoke import A2ACount, wire_counts
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch

    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (SB_BATCH, SB_PROMPT)).astype(np.int32))
    out, memos = {}, 0
    for shape in SB_LOCAL_MESHES:
        mesh = sb_mesh(shape)
        layout = partition.Layout.of(mesh, ("data",))
        for arch in SB_LOCAL_ARCHS:
            cfg0 = smoke_config(arch)
            tags = ("a2a", "opt") if cfg0.moe is not None else \
                ("bf16red", "opt")
            for tag in tags:
                cfg = cfg0.replace(quant=QuantConfig(**sb_quant(tag)))
                glob = partition.build_params(cfg, seed=0, device="cpu")
                local = partition.build_params(cfg, seed=0, layout=layout,
                                               device="cpu")
                key = f"local/{arch}/{tag}/{mesh_tag(shape)}"
                run = {}
                for part in (False, True):
                    rules = Rules(batch=("data",), mesh=mesh,
                                  partitioned=part, **SB_RULES[tag])
                    dispatch.reset_stats()
                    with use_rules(rules), A2ACount() as a2a, \
                            torch.no_grad():
                        run[part] = greedy(local if part else glob, toks,
                                           cfg, SB_LOCAL_STEPS,
                                           SB_PROMPT + SB_LOCAL_STEPS)
                    if part:
                        out.update(_sb_counts(key))
                        out[f"{key}/a2a"] = torch.tensor(a2a.n)
                for i, name in enumerate(("logits", "fed")):
                    out[f"{key}/{name}"] = run[True][i]
                    out[f"{key}/global/{name}"] = run[False][i]
                memos += _row_memos(local)
        # chip_smoke.py [tp-shard-bodies] (d): the bytes a rank sends in
        # layer 0's wo and MoE FFN, today and with both options, beside
        # their analytic counts
        cfg = smoke_config("llama4-scout-17b-a16e").replace(
            n_layers=1, quant=QuantConfig(**sb_quant("opt")))
        for (what, rules), (got, want) in wire_counts(
                cfg, mesh, layout, device="cpu").items():
            key = f"wire/{what}/{rules}/{mesh_tag(shape)}"
            for k in set(got) | set(want):
                out[f"{key}/{k}"] = torch.tensor(
                    [got.get(k, 0.0), want.get(k, 0.0)], dtype=torch.float64)
    out["local/row_memos"] = torch.tensor(memos)
    return out


def _local_rows(t, layout, batch_axes=("data",)):
    n = layout.size(batch_axes)
    rows = t.shape[0] // n
    i = layout.index(batch_axes)
    return t[i * rows:(i + 1) * rows]


def shard_jax_job(rank, ref):
    """The shard bodies on the rank's operands against ``jaxshard``'s
    reference (see the SB_* constants), and against the same bodies on
    the global tensors under the same rules on the same mesh."""
    import torch

    from chip_smoke import A2ACount
    from repro_torch import tree as tree_lib
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core import quant
    from repro_torch.core.api import QuantConfig, dense
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.layers import moe
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, init_opt_state
    out = {}

    # the row-parallel body alone
    for shape in SB_ROW_MESHES:
        mesh = sb_mesh(shape)
        layout = partition.Layout.of(mesh, ("data",))
        m, j = shape[1], layout.index(("model",))
        out[f"layout/{mesh_tag(shape)}"] = torch.tensor(
            [layout.index(("data",)), j])
        for name, _, packed in SB_ROW_CASES:
            key = f"row/{name}/{mesh_tag(shape)}"
            x = _tensors(ref, f"{key}/x")[f"{key}/x"]
            p = _tree(ref, f"{key}/p")
            qc = QuantConfig(w_bits=4, a_bits=8, mode="int",
                             pack_weights=packed)
            kl = x.shape[-1] // m
            unit = kl // 2 if packed else kl
            xl = _local_rows(x, layout)[..., j * kl:(j + 1) * kl]
            pl = dict(p, w_q=p["w_q"][:, j * unit:(j + 1) * unit]
                      .contiguous())
            for backend in ("cuda", "torch"):
                dispatch.reset_stats()
                with use_rules(Rules(batch=("data",), mesh=mesh,
                                     partitioned=True,
                                     int_bf16_reduce=True)), \
                        dispatch.use_backend(backend):
                    out[f"{key}/{backend}"] = dense(xl, pl, qc, tp="row",
                                                    k_split=True)
                out.update(_sb_counts(f"{key}/{backend}"))
            with use_rules(Rules(batch=("data",), mesh=mesh,
                                 int_bf16_reduce=True)):
                out[f"{key}/global"] = _local_rows(
                    dense(x, p, qc, tp="row"), layout)
            xq = quant.quantize_tensor(xl, 8)
            w = pl["w_q"]
            w = quant.unpack_int4(w) if packed else w
            out[f"{key}/codes"] = xq.q
            out[f"{key}/acc"] = quant.int_matmul_exact(
                xq.q.reshape(-1, kl), w.T).reshape(*xl.shape[:-1], -1)

    mesh = make_mesh((2, 2))
    layout = partition.Layout.of(mesh, ("data",))
    out["layout/2x2"] = torch.tensor([layout.index(("data",)),
                                      layout.index(("model",))])

    # the MoE FFN of layer 0, and a decode-sized call
    for arch in SB_MOE_ARCHS:
        cfg = smoke_config(arch).replace(quant=QuantConfig(
            **sb_quant("a2a")))
        glob = _tree(ref, f"{arch}/a2a/params")
        local = partition.partition_params(glob, cfg, layout)

        def ffn0(tree):
            return tree_lib.tree_map(lambda t: t[0],
                                     tree["units"]["b0"]["ffn"])
        for tag in ("moe", "decode"):
            x = _tensors(ref, f"{arch}/{tag}/x")[f"{arch}/{tag}/x"]
            key = f"{arch}/{tag}"
            rules = ("opt",) if tag == "moe" else ("a2a",)
            for rtag in rules:
                with use_rules(Rules(batch=("data",), mesh=mesh,
                                     partitioned=True, **SB_RULES[rtag])), \
                        A2ACount() as a2a:
                    y, aux = moe.moe_ffn(_local_rows(x, layout),
                                         ffn0(local), cfg.moe, cfg.quant,
                                         act=cfg.act)
                out.update({f"{key}/{rtag}/y": y,
                            f"{key}/{rtag}/lb": aux["lb_loss"],
                            f"{key}/{rtag}/a2a": torch.tensor(a2a.n)})
            if tag == "moe":
                with use_rules(Rules(batch=("data",), mesh=mesh,
                                     **SB_RULES["opt"])):
                    y, _ = moe.moe_ffn(x, ffn0(glob), cfg.moe, cfg.quant,
                                       act=cfg.act)
                out[f"{key}/global/y"] = _local_rows(y, layout)
            else:
                with use_rules(Rules(batch=("data",), mesh=mesh,
                                     partitioned=True)):
                    y, _ = moe.moe_ffn(_local_rows(x, layout), ffn0(local),
                                       cfg.moe, cfg.quant, act=cfg.act)
                out[f"{key}/dense/y"] = y

    # the a2a with gradients of sum(y ** 2) + lb_loss, float and fake
    mcfg = moe.MoEConfig(n_experts=A2A_E, top_k=A2A_K,
                         capacity_factor=A2A_CF)
    x = _local_rows(_tensors(ref, "a2a/x")["a2a/x"], layout)
    mj, di = layout.index(("model",)), layout.index(("data",))
    e_loc = A2A_E // 2
    for mode in ("float", "fake"):
        qc = None if mode == "float" else QuantConfig(w_bits=4, a_bits=8,
                                                      mode="fake")
        for fsdp in (False, True):
            p = {}
            for name, lin in _tree(ref, "a2a/p").items():
                w = lin["w"]
                if name.startswith("experts_"):
                    w = w[mj * e_loc:(mj + 1) * e_loc]
                    if fsdp:
                        c = w.shape[2] // 2
                        w = w[:, :, di * c:(di + 1) * c]
                p[name] = {"w": w.contiguous().requires_grad_(True)}
            rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                          moe_a2a=True, expert_fsdp=fsdp)
            with use_rules(rules):
                part = partition.active()
                y, aux = moe.moe_ffn(x, p, mcfg, qc)
                lb = part.counted(aux["lb_loss"])
                ((y ** 2).sum() + lb).backward()
                grads = {}
                for name, lin in p.items():
                    g = lin["w"].grad
                    split = name.startswith("experts_") and fsdp
                    grads[name] = {"w": g if split
                                   else part.sum(g, ("data",))}
            tag = f"a2a/{mode}/fsdp{int(fsdp)}"
            out.update({f"{tag}/y": y, f"{tag}/lb": aux["lb_loss"]})
            out.update(flat(grads, f"{tag}/grad/"))

    # one train step of Llama-4-Scout SMOKE through the all-to-all
    from repro_torch.configs import registry
    ocfg = OptConfig(**TRAIN_OPT)
    flayout = partition.Layout.of(mesh, ("data",), fsdp=True)
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                  moe_a2a=True, expert_fsdp=True)
    for case in SB_TRAIN_CASES:
        cfg = sb_train_config(case, lm, registry, QuantConfig)
        glob = _tree(ref, f"{case}/params")
        batch = batch_of(ref, case)
        loc = partition.partition_params(glob, cfg, flayout)
        with use_rules(rules), A2ACount() as a2a:
            shards = partition.opt_shards(loc, cfg)
            loss, _, grads = train.value_and_grad(
                train.model_loss(cfg), loc, batch, shards=shards)
            p = tree_lib.tree_map(torch.clone, loc)
            step = train.make_train_step(cfg, ocfg)
            p, _, met = step(p, init_opt_state(p, shards), batch)
        out.update({f"{case}/loss": loss, f"{case}/a2a": torch.tensor(a2a.n),
                    f"{case}/step/loss": met["loss"],
                    f"{case}/step/grad_norm": met["grad_norm"]})
        out.update(flat(grads, f"{case}/grads/"))
        out.update(flat(p, f"{case}/step/params/"))

    # greedy serving under the "opt" rules
    toks = torch.from_numpy(ref["tokens"])
    for arch in SB_GREEDY_ARCHS:
        cfg = smoke_config(arch).replace(quant=QuantConfig(
            **sb_quant("opt")))
        glob = _tree(ref, f"{arch}/opt/params")
        local = partition.partition_params(glob, cfg, layout)
        for part, tree in ((True, local), (False, glob)):
            with use_rules(Rules(batch=("data",), mesh=mesh,
                                 partitioned=part, **SB_RULES["opt"])), \
                    torch.no_grad():
                logits, fed, _ = greedy(tree, toks, cfg, SB_STEPS,
                                        SB_PROMPT + SB_STEPS)
            key = f"{arch}/opt/{'local' if part else 'global'}"
            out.update({f"{key}/logits": logits, f"{key}/fed": fed})

    # one int forward of the families under int_bf16_reduce at (1, 2)
    mesh = sb_mesh(SB_FAM_MESH)
    layout = partition.Layout.of(mesh, ("data",))
    for arch in SB_FAM_ARCHS:
        cfg = smoke_config(arch).replace(quant=QuantConfig(
            **sb_quant("bf16red")))
        glob = _tree(ref, f"{arch}/bf16red/params")
        batch = {k: torch.from_numpy(np.array(v)) for k, v in
                 _tensors(ref, f"{arch}/bf16red/batch/").items()}
        batch = {k.rsplit("/", 1)[-1]: v for k, v in batch.items()}
        local = partition.partition_params(glob, cfg, layout)
        model = model_of(cfg)
        for part, tree in ((True, local), (False, glob)):
            rules = Rules(batch=("data",), mesh=mesh, partitioned=part,
                          **SB_RULES["bf16red"])
            key = f"{arch}/bf16red/{'local' if part else 'global'}"
            dispatch.reset_stats()
            with use_rules(rules), torch.no_grad():
                logits, cache = model.prefill(tree, batch, cfg,
                                              SB_PROMPT + 1)
                out.update(_sb_counts(key))
                dispatch.reset_stats()
                tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
                step, _ = model.decode_step(tree, tok[:, None], cache, cfg)
            out.update({f"{key}/logits": logits, f"{key}/step": step})
            out.update(_sb_counts(f"{key}/step"))
    return out


def elastic_job(n, ref, tree_path):
    """Place the tree on best_mesh(n): each leaf's local shape on this
    rank, and the global tree gathered back (rank 0 saves it, as a
    checkpoint)."""
    import torch

    from repro_torch.distributed.elastic import best_mesh, reshard_to
    tree = _tree(ref, "elastic/params") if n == 8 else \
        unflat({k: torch.from_numpy(v) for k, v in load(tree_path).items()
                if k.startswith("tree/")}, "tree")
    mesh = best_mesh(n, device_type="cpu")
    placed = reshard_to(tree, mesh)
    out = {"mesh": torch.tensor(tuple(mesh.shape))}
    for k, v in flat(placed).items():
        out[f"shard/{k}"] = torch.tensor(v.to_local().shape)
        out[f"tree/{k}"] = v.full_tensor()
    return out


def partition_job(ref):
    """Every partitioned run of :func:`part_cases` on this rank (the
    rank's layout, the global logits and fed tokens, its cache shard, the
    dispatch counts), the refusals, the ``_row_codes`` copies on the local
    trees, and the local trees against
    ``distribute_tensor(...).to_local()``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import interop
    from repro_torch import tree as tree_lib
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import (Rules, filter_mesh_axes,
                                                  named_shardings,
                                                  param_specs, use_rules)
    from repro_torch.kernels import dispatch
    from repro_torch.launch.engine import PagedEngine
    from repro_torch.models import lm

    toks = _tensors(ref, "tokens")["tokens"]
    out = {}
    meshes = {mesh: make_mesh(mesh) for mesh in PART_MESHES}
    locals_ = {}
    for case in part_cases():
        arch, w, kv, mesh, backend, dtype = case
        m = mesh_tag(mesh)
        layout = partition.Layout.of(meshes[mesh], ("data",))
        out[f"layout/{m}"] = torch.tensor(
            [layout.index(("data",)), layout.index(("model",))])
        cfg = smoke_config(arch).replace(dtype=dtype, quant=QuantConfig(
            **part_quant(w, kv), backend=backend))
        if (arch, w, mesh, dtype) not in locals_:
            locals_[arch, w, mesh, dtype] = partition.partition_params(
                _tree(ref, f"{arch}/{w}/params"), cfg, layout) \
                if dtype == "float32" else partition.build_params(
                    cfg, seed=0, layout=layout, device="cpu")
        rules = Rules(batch=("data",), mesh=meshes[mesh], partitioned=True)
        dispatch.reset_stats()
        with use_rules(rules):
            logits, fed, cache = greedy(locals_[arch, w, mesh, dtype], toks,
                                        cfg)
        key = part_key(case)
        other = "torch" if backend == "cuda" else "cuda"
        out.update({f"{key}/logits": logits, f"{key}/fed": fed,
                    f"{key}/acc": torch.tensor(
                        dispatch.STATS[f"qlinear_acc_{backend}"]),
                    f"{key}/expert": torch.tensor(
                        dispatch.STATS[f"qexpert_{backend}"]),
                    f"{key}/other": torch.tensor(sum(
                        n for k, n in dispatch.STATS.items()
                        if k.endswith(f"_{other}")))})
        out.update(flat(cache, f"{key}/cache/"))

    # decode steps from JAX's prefill cache, carried into the rank's shard
    for mesh in PART_MESHES:
        layout = partition.Layout.of(meshes[mesh], ("data",))
        rules = Rules(batch=("data",), mesh=meshes[mesh], partitioned=True)
        for arch in PART_ARCHS:
            for w, kv in PART_FROM_JAX:
                tag = f"{arch}/{w}/kv{kv}"
                cfg = smoke_config(arch).replace(quant=QuantConfig(
                    **part_quant(w, kv)))
                cache = interop.to_torch_shard(
                    unflat(ref, f"jaxcache/{tag}"), cfg, layout, "cpu")
                tok = torch.from_numpy(ref[f"jaxtok/{tag}"])
                with use_rules(rules):
                    logits, fed = greedy_from(
                        locals_[arch, w, mesh, "float32"], cache, tok, cfg)
                key = f"fromjax/{tag}/{mesh_tag(mesh)}"
                out.update({f"{key}/logits": logits, f"{key}/fed": fed})

    # refusals, on (data 1, model 4)
    mesh = meshes[(1, 4)]
    cfg = smoke_config("qwen2.5-32b").replace(quant=QuantConfig(
        **part_quant("w8", 8)))
    glob = _tree(ref, "qwen2.5-32b/w8/params")
    refusals = {}

    def refused(name, err, fn, item="ROADMAP"):
        try:
            fn()
            refusals[name] = False
        except err as e:
            refusals[name] = item in str(e) or err is ValueError

    with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True)):
        refused("global_tree", ValueError, lambda: lm.prefill(
            glob, {"tokens": toks}, cfg, PART_MAX_LEN))
        refused("engine", NotImplementedError,
                lambda: PagedEngine(cfg, glob))
        refused("lm_loss", NotImplementedError, lambda: lm.lm_loss(
            glob, {"tokens": toks, "labels": toks}, cfg))
    out.update({f"refused/{k}": torch.tensor(v)
                for k, v in refusals.items()})
    # no partitioned run made a copy of a row-parallel weight's K slice
    out["row_memos"] = torch.tensor(sum(_row_memos(t)
                                        for t in locals_.values()))

    # the local trees against DTensor's shards of the same specs
    for m_shape, mesh in meshes.items():
        layout = partition.Layout.of(mesh, ("data",))
        for arch in PART_ARCHS:
            glob = _tree(ref, f"{arch}/w4p/params")
            loc = locals_[arch, "w4p", m_shape, "float32"]
            specs = filter_mesh_axes(param_specs(glob), mesh)
            same = checked = 0
            for g, l, pl in zip(tree_lib.leaves(glob), tree_lib.leaves(loc),
                                tree_lib.leaves(named_shardings(specs,
                                                                mesh))):
                d = distribute_tensor(g, mesh, pl).to_local()
                if tuple(d.shape) == tuple(l.shape):
                    checked += 1
                    same += int(torch.equal(d, l))
            out[f"dtensor/{arch}/{mesh_tag(m_shape)}"] = torch.tensor(
                [same, checked, len(tree_lib.leaves(glob))])
    return out


def families_job(ref):
    """Every partitioned family run of :func:`fam_cases` on this rank (its
    layout, the global logits and fed tokens, its cache shard, its int32
    row products and dispatches on the other backend), and the steps from
    JAX's prefill caches carried into its shard."""
    import torch

    from repro_torch import interop
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch

    out, locals_ = {}, {}
    for mesh in PART_MESHES:
        dm = make_mesh(mesh)
        m = mesh_tag(mesh)
        layout = partition.Layout.of(dm, ("data",))
        out[f"layout/{m}"] = torch.tensor(
            [layout.index(("data",)), layout.index(("model",))])
        rules = Rules(batch=("data",), mesh=dm, partitioned=True)
        for case in [c for c in fam_cases() if c[3] == mesh]:
            arch, w, kv, _ = case
            cfg = smoke_config(arch).replace(quant=QuantConfig(
                **part_quant(w, kv), backend="cuda"))
            if (arch, w) not in locals_:
                locals_[arch, w] = partition.partition_params(
                    _tree(ref, f"{arch}/{w}/params"), cfg, layout)
            dispatch.reset_stats()
            with use_rules(rules):
                logits, fed, cache = greedy(locals_[arch, w],
                                            fam_batch(ref, arch), cfg)
            key = fam_key(case)
            out.update({f"{key}/logits": logits, f"{key}/fed": fed,
                        f"{key}/acc": torch.tensor(
                            dispatch.STATS["qlinear_acc_cuda"]),
                        f"{key}/other": torch.tensor(sum(
                            n for k, n in dispatch.STATS.items()
                            if k.endswith("_torch")))})
            out.update(flat(cache, f"{key}/cache/"))
        for arch in FAM_ARCHS:
            for w, kv in PART_FROM_JAX:
                tag = f"{arch}/{w}/kv{kv}"
                cfg = smoke_config(arch).replace(quant=QuantConfig(
                    **part_quant(w, kv)))
                cache = interop.to_torch_shard(
                    unflat(ref, f"jaxcache/{tag}"), cfg, layout, "cpu")
                tok = torch.from_numpy(ref[f"jaxtok/{tag}"])
                with use_rules(rules):
                    logits, fed = greedy_from(locals_[arch, w], cache, tok,
                                              cfg)
                out.update({f"fromjax/{tag}/{m}/logits": logits,
                            f"fromjax/{tag}/{m}/fed": fed})
        locals_.clear()
    return out


# the group max's ties: (rows, cols) of the tensor, its integer values'
# range (so maxima tie within and across ranks), and each rank's weight in
# the loss (powers of two summing to one: the sum of the parts is exact)
TIES_SHAPE, TIES_RANGE, TIES_WEIGHTS = (8, 16), 4, (0.5, 0.25, 0.125, 0.125)


def ties_job(rank, ref):
    """The group max's values and gradients on this rank: per tensor over
    (data 2, model 2) (rows over "data", columns over "model") and per
    column over a K split over (model 4); each rank's loss its weight
    times the max (times the columns' weights)."""
    import torch

    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    x = torch.from_numpy(ref["ties/x"])
    c = torch.from_numpy(ref["ties/c"])
    w = TIES_WEIGHTS[rank]
    out = {}
    for tag, shape in (("tensor", (2, 2)), ("column", (1, 4))):
        mesh = make_mesh(shape)
        layout = partition.Layout.of(mesh, ("data",))
        rows = x.shape[0] // shape[0]
        cols = x.shape[1] // shape[1]
        if tag == "tensor":
            i, j = layout.index(("data",)), layout.index(("model",))
            xl = x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
        else:
            k = x.shape[0] // 4
            xl = x[rank * k:(rank + 1) * k]
        xl = xl.clone().requires_grad_(True)
        with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True)):
            if tag == "tensor":
                amax = partition.grid_max(xl.abs(), None, batch=True)
                loss = amax * w
            else:
                amax = partition.grid_max(xl.abs(), 0)
                loss = (amax[0] * c).sum() * w
            loss.backward()
        out[f"ties/{tag}/amax"] = amax.detach()
        out[f"ties/{tag}/grad"] = xl.grad
    return out


def train_job(rank, ref):
    """The partitioned train cell of the decoder LMs on this rank
    (:func:`train_cases`: TRAIN_CASES) after the group max's ties, then
    the refusals that remain."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.api import QuantConfig
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.launch.engine import PagedEngine
    from repro_torch.models import encdec, lm
    out = ties_job(rank, ref)
    out.update(train_cases(ref, TRAIN_CASES))

    # refusals of the train path, on (data 2, model 2): the paged engine,
    # lm_loss and encdec.loss_fn in int mode, and a global tree
    mesh = make_mesh((2, 2))
    toks = torch.from_numpy(ref["qwen-fake/batch/tokens"])
    batch = {"tokens": toks, "labels": toks}
    cfg = train_config("qwen-fake", lm, registry, QuantConfig)
    glob = _tree(ref, "qwen-fake/params")
    refusals = {}

    def refused(name, err, fn):
        try:
            fn()
            refusals[name] = False
        except err as e:
            refusals[name] = "ROADMAP" in str(e) or err is ValueError

    with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True,
                         expert_fsdp=True)):
        refused("engine", NotImplementedError,
                lambda: PagedEngine(cfg, glob))
        refused("int_loss", NotImplementedError, lambda: lm.lm_loss(
            glob, batch, cfg.replace(quant=QuantConfig(**TRAIN_SERVE))))
        wc = registry.smoke_config("whisper-large-v3").replace(
            quant=QuantConfig(**TRAIN_SERVE))
        refused("int_encdec_loss", NotImplementedError,
                lambda: encdec.loss_fn({}, batch, wc))
        refused("global_tree", ValueError, lambda: lm.lm_loss(
            glob, batch, cfg))
    out.update({f"refused/{k}": torch.tensor(v)
                for k, v in refusals.items()})
    return out


def train_cases(ref, cases):
    """The partitioned train cell on this rank, each case of ``cases`` on
    each mesh of TRAIN_MESHES (rules with ``expert_fsdp``; the case's loss
    by ``train.model_loss``): (replay) the loss and gradients on the recorded
    codes of JAX's one-device run, (opt) one LAMB update on JAX's
    one-device gradients, (step) ``make_train_step`` on the rank's own
    codes, and for the fake cases the stepped tree integerized locally and
    served partitioned."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, init_opt_state, opt_update
    out = {}
    ocfg = OptConfig(**TRAIN_OPT)
    for shape in TRAIN_MESHES:
        mesh = make_mesh(shape)
        m = mesh_tag(shape)
        layout = partition.Layout.of(mesh, ("data",), fsdp=True)
        out[f"layout/{m}"] = torch.tensor(
            [layout.index(("data",)), layout.index(("model",))])
        rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                      expert_fsdp=True)
        for case in cases:
            cfg = train_config(case, lm, registry, QuantConfig)
            loss_fn = train.model_loss(cfg)
            key = f"{case}/{m}"
            glob = _tree(ref, f"{case}/params")
            batch = batch_of(ref, case)
            loc = partition.partition_params(glob, cfg, layout)
            with use_rules(rules):
                shards = partition.opt_shards(loc, cfg)
                if cfg.quant is None:
                    loss, _, grads = train.value_and_grad(
                        loss_fn, loc, batch, shards=shards)
                else:
                    with BlockReplay(*records_from(ref, f"{case}/rec")) \
                            as rep:
                        loss, _, grads = train.value_and_grad(
                            loss_fn, loc, batch, shards=shards)
                    out[f"{key}/replay/flips"] = torch.tensor(rep.flips())
                out[f"{key}/replay/loss"] = loss
                out.update(flat(grads, f"{key}/replay/grads/"))

                jg = partition.partition_params(_tree(ref, f"{case}/jgrads"),
                                                cfg, layout)
                p = tree_lib.tree_map(torch.clone, loc)
                state = init_opt_state(p, shards)
                out.update(flat(state["mu"], f"{key}/mu/"))
                opt_update(p, jg, state, ocfg, shards=shards)
                out.update(flat(p, f"{key}/opt/params/"))

                p = tree_lib.tree_map(torch.clone, loc)
                step = train.make_train_step(cfg, ocfg)
                p, _, met = step(p, init_opt_state(p, shards), batch)
                out.update({f"{key}/step/loss": met["loss"],
                            f"{key}/step/grad_norm": met["grad_norm"]})
                out.update(flat(p, f"{key}/step/params/"))
                if cfg.quant is None:
                    continue
                iq = integerize_params(p, QuantConfig(**TRAIN_SERVE))
            out.update(flat(iq, f"{key}/int/"))
            # the kernels take contiguous operands only
            out[f"{key}/int_contiguous"] = torch.tensor(all(
                t.is_contiguous() for t in tree_lib.leaves(iq)))
            icfg = cfg.replace(quant=QuantConfig(**TRAIN_SERVE))
            with use_rules(Rules(batch=("data",), mesh=mesh,
                                 partitioned=True)), torch.no_grad():
                logits, fed = serve_steps(iq, batch, icfg)
            out.update({f"{key}/serve/logits": logits,
                        f"{key}/serve/fed": fed})
    return out


def train_layouts(ranks, shape, fsdp=True):
    """Each rank's ``Layout`` on the (data, model) mesh ``shape``, from
    its saved coordinates."""
    from repro_torch.distributed import partition
    sizes = {"data": shape[0], "model": shape[1]}
    out = []
    for r in ranks:
        di, mi = r[f"layout/{mesh_tag(shape)}"]
        out.append(partition.Layout.make(sizes, {"data": int(di),
                                                 "model": int(mi)},
                                         ("data",), fsdp))
    return out


def gathered(ranks, shape, prefix, cfg, fsdp=True):
    """The global tree of every rank's local tree under ``prefix``."""
    import torch

    from repro_torch.distributed import partition
    parts = []
    for layout, r in zip(train_layouts(ranks, shape, fsdp), ranks):
        local = {k: torch.from_numpy(v) for k, v in r.items()
                 if k.startswith(prefix + "/")}
        parts.append((layout, unflat(local, prefix)))
    return partition.gather_params(parts, cfg)


def close_leaves(got, want, tol, what):
    """Every leaf of ``got`` within ``tol`` of its leaf's max in ``want``
    (trees of tensors or numpy arrays, one key order)."""
    g = _np(got)
    w = {k: np.asarray(v, np.float32) for k, v in flat(want).items()}
    assert sorted(g) == sorted(w), what
    for k in w:
        err = np.abs(g[k] - w[k]).max()
        assert err <= tol * (np.abs(w[k]).max() + 1e-30), (what, k, err)


def serve_steps(params, batch, cfg):
    """Ring prefill of the first TRAIN_SERVE_PROMPT tokens of ``batch``
    (Whisper's with its frames) and TRAIN_SERVE_STEPS greedy steps:
    (logits (steps + 1, B, 1, V), fed (steps, B, 1))."""
    import torch

    model = model_of(cfg)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    prompt["tokens"] = prompt["tokens"][:, :TRAIN_SERVE_PROMPT]
    logits, cache = model.prefill(params, prompt, cfg,
                                  TRAIN_SERVE_PROMPT + TRAIN_SERVE_STEPS)
    out, fed = [logits], []
    for _ in range(TRAIN_SERVE_STEPS):
        fed.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        logits, cache = model.decode_step(params, fed[-1], cache, cfg)
        out.append(logits)
    return torch.stack(out), torch.stack(fed)


# ---------------------------------------------------------------------------
# Replaying one run's fake-quant codes into another, block by block
# ---------------------------------------------------------------------------

def _blocks(small, big):
    """The index tuples of every block of shape ``small`` that tiles
    ``big`` (none unless each dim divides)."""
    if len(small) != len(big) or any(b % s for s, b in zip(small, big)):
        return []
    return [tuple(slice(k * s, (k + 1) * s) for k, s in zip(ks, small))
            for ks in itertools.product(*(range(b // s)
                                          for s, b in zip(small, big)))]


def _at(t, idx, shape):
    """``t`` (broadcastable to ``shape``, as a grid step is) at block
    ``idx`` of ``shape``."""
    if t.ndim == 0:
        return t
    pad = len(shape) - t.ndim
    return t[tuple(slice(None) if t.shape[d - pad] == 1 else idx[d]
                   for d in range(pad, len(shape)))]


def _replayed():
    import torch

    from repro_torch.core import quant

    class Replayed(torch.autograd.Function):
        """fake_quant on another run's call: the forward returns that
        run's output, the backward is the port's own STE / LSQ
        (``quant._lsq_grads``) on this run's ``x / delta`` and that run's
        codes."""

        @staticmethod
        def forward(ctx, x, delta, bits, unsigned, rec):
            _, rdelta, _, _, value = rec
            dt = torch.promote_types(x.dtype, delta.dtype)
            ctx.save_for_backward(x.to(dt) / delta.to(dt),
                                  torch.round(value.to(dt) / rdelta.to(dt)))
            ctx.delta_shape, ctx.delta_dtype = delta.shape, delta.dtype
            ctx.qrange = quant.qrange(bits, unsigned=unsigned)
            return value.to(x.dtype).clone()

        @staticmethod
        def backward(ctx, g):
            return (*quant._lsq_grads(ctx, g, *ctx.saved_tensors), None)
    return Replayed


class BlockReplay:
    """Within ``with``: each of the port's fake_quant calls takes the
    output of a recorded run's call (``records``: (x, delta, bits,
    unsigned, out), the whole tensors) at the block its own ``x`` is of,
    the nearest in x over every record of its bits and signedness and
    every block (a rank holds blocks: rows, heads, a K slice, experts); its
    gradient is the port's own on those codes.  The fake attention's
    ``exp2_shift`` calls take the recorded run's side of every kink of
    ``floor`` (``exp2``: the recorded inputs, matched the same way).
    ``calls`` holds the port's own calls and ``matched`` the blocks of the
    records they took, for ``chip_smoke.code_flips``; ``kinks`` counts the
    kinks taken."""

    def __init__(self, records, exp2=()):
        self.records, self.exp2 = records, list(exp2)
        self.calls, self.matched, self.kinks = [], [], 0
        self._next = {"fq": 0, "exp2": 0}

    def __enter__(self):
        from repro_torch.core import quant
        from repro_torch.layers import attention
        self.replayed = _replayed()
        self.orig = quant.fake_quant
        quant.fake_quant = self
        self.orig_exp2 = attention.exp2_shift
        attention.exp2_shift = self.exp2_shift
        return self

    def __exit__(self, *exc):
        from repro_torch.core import quant
        from repro_torch.layers import attention
        quant.fake_quant = self.orig
        attention.exp2_shift = self.orig_exp2

    def _find(self, x, key, tensors, ok=lambda i: True):
        """(gap, i, block) of the record nearest ``x``: the one after the
        last match first (the runs' orders mostly agree), else all."""
        def gap(i):
            best = (float("inf"), i, None)
            for idx in _blocks(tuple(x.shape), tuple(tensors[i].shape)):
                t = tensors[i][idx]
                g = float((t - x).abs().max() / (t.abs().max() + 1e-30))
                best = min(best, (g, i, idx), key=lambda b: b[0])
            return best
        n = self._next[key]
        if n < len(tensors) and ok(n):
            found = gap(n)
            if found[0] <= 1e-6:
                self._next[key] = n + 1
                return found
        found = min((gap(i) for i in range(len(tensors)) if ok(i)),
                    key=lambda b: b[0], default=(float("inf"), None, None))
        self._next[key] = (found[1] or 0) + 1
        return found

    def __call__(self, x, delta, bits, unsigned=False):
        import torch
        with torch.no_grad():
            own = self.orig(x, delta, bits, unsigned)
            xd = x.detach().clone()    # a training step updates in place
            gap, i, idx = self._find(
                xd, "fq", [r[0] for r in self.records],
                lambda i: self.records[i][2:4] == (bits, unsigned))
        assert gap <= 1e-4, f"no recorded fake_quant call matches ({gap})"
        rx, rd, _, _, ry = self.records[i]
        rec = (rx[idx], _at(rd, idx, rx.shape), bits, unsigned, ry[idx])
        self.calls.append((xd, delta.detach().clone(), bits, unsigned, own))
        self.matched.append(rec)
        return self.replayed.apply(x, delta, bits, unsigned, rec)

    def exp2_shift(self, x):
        import torch

        from chip_smoke import FLIP_NEAR
        from repro_torch.core import softmax2
        with torch.no_grad():
            gap, i, idx = self._find(x.detach(), "exp2", self.exp2)
            assert gap <= 1e-4, f"no recorded exp2_shift call ({gap})"
            tj = self.exp2[i][idx]
            # the row's floor-max shift between the runs (an integer),
            # then the record's floor in this run's frame
            shift = torch.round(x - tj)
            f = torch.floor(tj) + shift
            kink = f != torch.floor(x)
            assert bool(((x - tj - shift).abs()[kink] <= FLIP_NEAR).all())
            self.kinks += int(kink.sum())
        return (1.0 + (x - f)) * softmax2.exp2i(f)

    def flips(self) -> int:
        """The codes the port's own calls would have taken otherwise; each
        must be at a rounding edge (``chip_smoke.code_flips``)."""
        from chip_smoke import code_flips
        total, primary, _ = code_flips(self.matched, self.calls,
                                       a_exact=False)
        assert total == primary, f"{total - primary} of {total} flips off " \
            f"an edge"
        return total


def records_to(arrays, prefix, rec):
    """A BlockReplay's records (and ``rec.exp2``) into npz ``arrays``."""
    for i, (x, d, bits, unsigned, y) in enumerate(rec):
        arrays.update({f"{prefix}/fq/{i}/x": x, f"{prefix}/fq/{i}/d": d,
                       f"{prefix}/fq/{i}/y": y,
                       f"{prefix}/fq/{i}/kind": np.array([bits, unsigned])})
    for i, t in enumerate(rec.exp2):
        arrays[f"{prefix}/exp2/{i}"] = t


def records_from(ref, prefix):
    """(records, exp2) saved by :func:`records_to`, as CPU tensors."""
    t = _tensors(ref, prefix + "/")
    recs, exp2 = [], []
    for i in itertools.count():
        if f"{prefix}/fq/{i}/x" not in t:
            break
        bits, unsigned = (int(v) for v in t[f"{prefix}/fq/{i}/kind"])
        recs.append((t[f"{prefix}/fq/{i}/x"], t[f"{prefix}/fq/{i}/d"], bits,
                     bool(unsigned), t[f"{prefix}/fq/{i}/y"]))
    for i in itertools.count():
        if f"{prefix}/exp2/{i}" not in t:
            break
        exp2.append(t[f"{prefix}/exp2/{i}"])
    return recs, exp2


# the dry run (tests/test_torch_dryrun.py): production cells whose rank-0
# layout is held against the reference's shardings, and SMOKE cells run
# on real CPU tensors under gloo against meta under the fake group
DRYRUN_LAYOUT_CELLS = (("qwen2.5-32b", "decode_32k", "single"),
                       ("llama4-scout-17b-a16e", "train_4k", "multi"),
                       ("recurrentgemma-9b", "long_500k", "single"),
                       ("whisper-large-v3", "prefill_32k", "single"))
# (tag, arch, shape, seq, global batch, variant)
DRYRUN_CASES = (("llama-train", "llama4-scout-17b-a16e", "train_4k", 32, 8,
                 None),
                ("qwen-decode", "qwen2.5-32b", "decode_32k", 40, 4, None),
                ("llama-prefill-opt", "llama4-scout-17b-a16e", "prefill_32k",
                 32, 8, "opt"))
DRYRUN_MESHES = ((2, 2), (1, 4))


def jax_dryrun(out_path):
    """The reference's cells of DRYRUN_LAYOUT_CELLS, as ``jaxdryrun``
    writes them: {"arch|shape|mesh/arg/leaf path": [global shape, shard
    shape, item size]}."""
    import json

    from repro.launch import dryrun        # sets its 512 host devices
    import jax
    from repro.launch.mesh import make_production_mesh
    out = {}
    for arch, shape, mesh_kind in DRYRUN_LAYOUT_CELLS:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        _, args, shardings, *_ = dryrun._make_cell(arch, shape, mesh)
        kind = dryrun.SHAPES[shape][2]
        names = {"train": ("params", "opt_state", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "token", "cache")}[kind]
        for name, arg, sh in zip(names, args, shardings):
            leaves = jax.tree_util.tree_flatten_with_path(arg)[0]
            for (path, leaf), s in zip(leaves,
                                       jax.tree_util.tree_leaves(sh)):
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                out[f"{arch}|{shape}|{mesh_kind}/{name}/{key}".rstrip("/")] \
                    = [list(leaf.shape), list(s.shard_shape(leaf.shape)),
                       leaf.dtype.itemsize]
    with open(out_path, "w") as f:
        json.dump(out, f)


def dryrun_job(rank):
    """DRYRUN_CASES on each mesh of DRYRUN_MESHES, on this rank's real CPU
    tensors: what ``repro_torch.launch.dryrun.measure`` counts."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    out = {}
    for shape in DRYRUN_MESHES:
        mesh = make_mesh(shape)
        for tag, arch, cell_shape, seq, batch, variant in DRYRUN_CASES:
            cell = dryrun._make_cell(arch, cell_shape, mesh,
                                     cfg=registry.smoke_config(arch),
                                     seq=seq, batch=batch, variant=variant,
                                     device="cpu")
            rec, _ = dryrun.measure(cell, memory=False)
            key = f"{mesh_tag(shape)}/{tag}"
            out[f"{key}/args"] = torch.tensor(
                rec["memory"]["argument_size_in_bytes"])
            out[f"{key}/flops"] = torch.tensor(rec["cost"]["flops"])
            for what in ("wire", "collectives", "launches"):
                for k, v in rec[what].items():
                    out[f"{key}/{what}/{k}"] = torch.tensor(
                        float(v), dtype=torch.float64)
    return out


# ---------------------------------------------------------------------------
# The residual's sequence split (Rules.seq_tp)
# ---------------------------------------------------------------------------

# tests/test_torch_partition_sp.py: the decoder families' SMOKE configs
# served in int mode (int8 weights, kv 8) under Rules(partitioned, seq_tp)
# and without seq_tp, on (data, model) meshes (1, 4) and (2, 2): prompts
# of 32 (m divides S: the residual splits) and 31 (it stays whole), then
# SP_STEPS greedy ring steps (S = 1: whole); Qwen2.5 SMOKE at 2 layers
# against the reference's own seq_tp run (jaxsp) on a (1, 4) host mesh
SP_ARCHS = ("qwen2.5-32b", "llama4-scout-17b-a16e", "recurrentgemma-9b",
            "mamba2-130m")
SP_MESHES = ((1, 4), (2, 2))
SP_PROMPTS = (32, 31)
SP_BATCH, SP_STEPS, SP_MAX_LEN = 4, 4, 40
SP_JAX_LAYERS = 2
# tests/test_torch_partition_sp_train.py: lm_loss and its gradients in
# fake mode (the partitioned train cells above) with and without seq_tp
SP_TRAIN_CASES = ("qwen-fake", "llama-fake", "rg-fake", "mamba-fake")
# and against the reference's own seq_tp train cell (jaxsptrain, (1, 4))
SP_JAX_TRAIN_CASE = "qwen-fake"
# int32 sums reduce-scattered over 4 ranks: each term below 2^26, so the
# sums pass 2^24, where f32 stops holding every integer
SP_RS_ROWS, SP_RS_COLS = 16, 8


def sp_tokens(s):
    return np.random.RandomState(11).randint(
        0, 512, (SP_BATCH, s)).astype(np.int32)


def sp_rs_terms(rank):
    """Rank ``rank``'s int32 terms of the exact reduce-scatter case."""
    return np.random.RandomState(100 + rank).randint(
        1 << 25, 1 << 26, (SP_RS_ROWS, SP_RS_COLS)).astype(np.int32)


def jax_sp(out_path):
    """The reference's own ``seq_tp`` run: Qwen2.5 SMOKE at SP_JAX_LAYERS
    layers, int mode (int8 weights, kv 8), ``jax.jit`` prefill of the
    32-token prompts and SP_STEPS greedy ring steps under
    ``Rules(batch=("data",), seq_tp=("model",))`` on a (data 1, model 4)
    host mesh; with its params and prompts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs.registry import smoke_config
    from repro.core.api import QuantConfig, integerize_params
    from repro.distributed.sharding import Rules, use_rules
    from repro.models import lm

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                ("data", "model"))
    qc = QuantConfig(**part_quant("w8", 8))
    cfg = smoke_config("qwen2.5-32b").replace(n_layers=SP_JAX_LAYERS,
                                              quant=qc)
    params = jax.jit(lambda k: integerize_params(
        lm.init_params(k, cfg.replace(quant=None)), qc))(
            jax.random.PRNGKey(0))
    toks = sp_tokens(SP_PROMPTS[0])
    res = {"tokens": toks}
    res.update(flat(params, "params/"))
    rules = Rules(batch=("data",), mesh=mesh, seq_tp=("model",))
    with mesh, use_rules(rules):
        logits, cache = jax.jit(lambda p, b: lm.prefill(
            p, b, cfg, SP_MAX_LEN))(params, {"tokens": toks})
        step = jax.jit(lambda p, t, c: lm.decode_step(p, t, c, cfg))
        out, fed = [logits], []
        for _ in range(SP_STEPS):
            fed.append(jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
                       [:, None])
            logits, cache = step(params, fed[-1], cache)
            out.append(logits)
    res["logits"] = np.stack([np.asarray(t) for t in out])
    res["fed"] = np.stack([np.asarray(t) for t in fed])
    tmp = out_path + ".part.npz"
    save(tmp, res)
    os.replace(tmp, out_path)


def jax_sp_train(out_path):
    """The reference's own ``seq_tp`` train cell: Qwen2.5 SMOKE in fake
    mode (``train_config("qwen-fake")``), ``jax.jit`` of
    ``value_and_grad(lm_loss)`` under ``Rules(batch=("data",),
    seq_tp=("model",))`` on a (data 1, model 4) host mesh; its params,
    batch, loss and gradients, and every fake-quant call's (x, delta,
    output) and fake attention ``exp2_shift`` input in
    :func:`records_to`'s layout.  JAX takes no ordered callback in a
    program over more than one device, so the records come in no order;
    :class:`BlockReplay` matches each call by its x."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import registry
    from repro.core import quant as jquant
    from repro.core.api import QuantConfig
    from repro.distributed.sharding import Rules, use_rules
    from repro.layers import attention as jattn
    from repro.models import lm

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                ("data", "model"))
    cfg = train_config(SP_JAX_TRAIN_CASE, lm, registry, QuantConfig)
    params = jax.jit(lambda k: lm.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    batch = train_batch(SP_JAX_TRAIN_CASE, cfg)
    class Records(list):
        exp2 = []
    rec, fq, exp2_shift = Records(), jquant.fake_quant, jattn.exp2_shift

    def fake_quant(x, delta, bits, unsigned=False):
        y = fq(x, delta, bits, unsigned)
        jax.debug.callback(lambda a, d, o: rec.append(
            (np.asarray(a), np.asarray(d), bits, unsigned, np.asarray(o))),
            x, delta, y)
        return y

    def exp2_recorded(t):
        jax.debug.callback(lambda a: rec.exp2.append(np.asarray(a)), t)
        return exp2_shift(t)

    jquant.fake_quant, jattn.exp2_shift = fake_quant, exp2_recorded
    try:
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: lm.lm_loss(p, b, cfg), has_aux=True))
        with mesh, use_rules(Rules(batch=("data",), mesh=mesh,
                                   seq_tp=("model",))):
            (loss, _), grads = vg(params, batch)
            jax.block_until_ready(grads)
            jax.effects_barrier()
    finally:
        jquant.fake_quant, jattn.exp2_shift = fq, exp2_shift
    case = SP_JAX_TRAIN_CASE
    res = {f"{case}/loss": loss}
    res.update(flat(params, f"{case}/params/"))
    res.update(flat(batch, f"{case}/batch/"))
    res.update(flat(grads, f"{case}/grads/"))
    records_to(res, f"{case}/rec", rec)
    tmp = out_path + ".part.npz"
    save(tmp, res)
    os.replace(tmp, out_path)


def wait_for(path, timeout=200):
    """Load the npz a process beside this one writes to ``path`` (it
    renames it into place whole) once it exists."""
    import time
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"no {path}")
        time.sleep(0.5)
    return load(path)


def _sp_rules(mesh, sp, **kw):
    from repro_torch.distributed.sharding import Rules
    return Rules(**{"batch": ("data",), "mesh": mesh, "partitioned": True,
                    "seq_tp": ("model",) if sp else (), **kw})


def sp_job(rank, ref_path):
    """This rank's part of tests/test_torch_partition_sp.py: the exact
    int32 reduce-scatter; every serving run of SP_ARCHS x SP_MESHES x
    SP_PROMPTS with and without seq_tp (logits, fed tokens, the rank's
    cache shard, the bytes it sent, the dispatch counts); one layer's
    bytes against ``chip_smoke.sp_wire_analytic``; the refusals; then,
    once ``jaxsp`` has written ``ref_path``, the reference's tree served
    under seq_tp."""
    import torch

    from chip_smoke import sp_wire_counts, wire_snapshot
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm

    out = {}
    meshes = {shape: make_mesh(shape) for shape in SP_MESHES}
    # the int32 reduce-scatter, exact past 2^24
    grp = meshes[(1, 4)].get_group("model")
    out["rs/int32"] = col.reduce_scatter_dim(
        torch.from_numpy(sp_rs_terms(rank)), [grp], 0)
    qc = QuantConfig(**part_quant("w8", 8))
    for shape, mesh in meshes.items():
        layout = partition.Layout.of(mesh, ("data",))
        m = mesh_tag(shape)
        out[f"layout/{m}"] = torch.tensor(
            [layout.index(("data",)), layout.index(("model",))])
        for arch in SP_ARCHS:
            cfg = smoke_config(arch).replace(quant=qc)
            local = partition.build_params(cfg, seed=0, layout=layout,
                                           device="cpu")
            for s in SP_PROMPTS:
                toks = torch.from_numpy(sp_tokens(s))
                for sp in (False, True):
                    key = f"{arch}/{m}/s{s}/{'sp' if sp else 'base'}"
                    col.reset_wire()
                    dispatch.reset_stats()
                    with use_rules(_sp_rules(mesh, sp)), torch.no_grad():
                        logits, fed, cache = greedy(local, toks, cfg,
                                                    SP_STEPS, SP_MAX_LEN)
                    out.update({f"{key}/logits": logits, f"{key}/fed": fed,
                                f"{key}/acc": torch.tensor(
                                    dispatch.STATS["qlinear_acc_cuda"])})
                    out.update({f"{key}/{k}": torch.tensor(
                        float(v), dtype=torch.float64)
                        for k, v in wire_snapshot().items()})
                    out.update(flat(cache, f"{key}/cache/"))
            # one layer's bytes: what the split changes, against the
            # analytic count
            got, want = sp_wire_counts(cfg, mesh, layout, SP_BATCH,
                                       SP_PROMPTS[0], device="cpu")
            for what, counts in (("got", got), ("want", want)):
                for k, v in counts.items():
                    out[f"layerwire/{arch}/{m}/{what}/{k}"] = torch.tensor(
                        float(v), dtype=torch.float64)

    # refusals, on (data 1, model 4)
    mesh = meshes[(1, 4)]
    cfg = smoke_config("qwen2.5-32b").replace(quant=qc)
    local = partition.build_params(cfg, seed=0, layout=partition.Layout.of(
        mesh, ("data",)), device="cpu")
    toks = torch.from_numpy(sp_tokens(SP_PROMPTS[0]))
    for name, err, rules in (
            ("bf16red", NotImplementedError,
             _sp_rules(mesh, True, int_bf16_reduce=True)),
            ("a2a", NotImplementedError, _sp_rules(mesh, True, moe_a2a=True)),
            ("data_axis", ValueError, _sp_rules(mesh, True,
                                                seq_tp=("data",)))):
        try:
            with use_rules(rules), torch.no_grad():
                lm.prefill(local, {"tokens": toks}, cfg, SP_MAX_LEN)
            ok = False
        except err as e:
            ok = err is ValueError or "ROADMAP.md" in str(e)
        out[f"refused/{name}"] = torch.tensor(ok)

    # the reference's seq_tp run (jaxsp, beside these ranks)
    ref = wait_for(ref_path)
    cfg = smoke_config("qwen2.5-32b").replace(n_layers=SP_JAX_LAYERS,
                                              quant=qc)
    glob = _tree(ref, "params")
    toks = torch.from_numpy(ref["tokens"])
    for shape, mesh in meshes.items():
        local = partition.partition_params(glob, cfg, partition.Layout.of(
            mesh, ("data",)))
        with use_rules(_sp_rules(mesh, True)), torch.no_grad():
            logits, fed, _ = greedy(local, toks, cfg, SP_STEPS, SP_MAX_LEN)
        out[f"jax/{mesh_tag(shape)}/logits"] = logits
        out[f"jax/{mesh_tag(shape)}/fed"] = fed
    return out


def sp_train_job(rank, ref_path):
    """This rank's part of tests/test_torch_partition_sp_train.py: each
    case of SP_TRAIN_CASES on each mesh of SP_MESHES (rules with
    ``expert_fsdp``, the rank's tree from ``partition.build_params``):
    ``lm_loss`` and the rank's gradients (summed over the batch axes)
    without and with seq_tp, each on its own fake-quant codes; past two
    model ranks also the codes that differ between the two runs
    (``chip_smoke.code_flips``, in all and call by call) and the seq_tp
    run on the codes of the run without it (``chip_smoke.FakeQuantTap``).
    Then, once
    ``jaxsptrain`` has written ``ref_path``, its tree and batch under
    seq_tp on each mesh: on the reference's codes (:class:`BlockReplay`;
    every code the rank's own would have taken otherwise at a rounding
    edge) and on the rank's own."""
    import torch

    from chip_smoke import FakeQuantTap, code_flips
    from repro_torch.configs import registry
    from repro_torch.core.api import QuantConfig
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch import train
    from repro_torch.models import lm

    out = {}
    for shape in SP_MESHES:
        mesh = make_mesh(shape)
        layout = partition.Layout.of(mesh, ("data",), fsdp=True)
        for case in SP_TRAIN_CASES:
            cfg = train_config(case, lm, registry, QuantConfig)
            batch = {k: torch.from_numpy(v)
                     for k, v in train_batch(case, cfg).items()}
            local = partition.build_params(cfg, seed=0, layout=layout,
                                           device="cpu")
            key = f"{case}/{mesh_tag(shape)}"

            def run(sp, tag, replay=None):
                with use_rules(_sp_rules(mesh, sp, expert_fsdp=True)), \
                        FakeQuantTap(replay) as tap:
                    loss, _, grads = train.value_and_grad(
                        train.model_loss(cfg), local, batch,
                        shards=partition.opt_shards(local, cfg))
                out[f"{key}/{tag}/loss"] = loss
                out.update(flat(grads, f"{key}/{tag}/grads/"))
                return tap.calls
            base = run(False, "base")
            own = run(True, "sp")
            if shape[1] > 2:
                out[f"{key}/flips"] = torch.tensor(code_flips(base, own))
                out[f"{key}/flips_by_call"] = torch.tensor(
                    [code_flips([a], [b]) for a, b in zip(base, own)])
                run(True, "replay", base)

    # the reference's seq_tp train cell (jaxsptrain, beside these ranks)
    ref = wait_for(ref_path)
    case = SP_JAX_TRAIN_CASE
    cfg = train_config(case, lm, registry, QuantConfig)
    glob = _tree(ref, f"{case}/params")
    batch = batch_of(ref, case)
    records = records_from(ref, f"{case}/rec")
    for shape in SP_MESHES:
        mesh = make_mesh(shape)
        m = mesh_tag(shape)
        layout = partition.Layout.of(mesh, ("data",), fsdp=True)
        out[f"layout/{m}"] = torch.tensor(
            [layout.index(("data",)), layout.index(("model",))])
        local = partition.partition_params(glob, cfg, layout)
        with use_rules(_sp_rules(mesh, True, expert_fsdp=True)):
            shards = partition.opt_shards(local, cfg)
            with BlockReplay(*records) as rep:
                loss, _, grads = train.value_and_grad(
                    train.model_loss(cfg), local, batch, shards=shards)
            out[f"jax/{m}/replay/flips"] = torch.tensor(rep.flips())
            out[f"jax/{m}/replay/loss"] = loss
            out.update(flat(grads, f"jax/{m}/replay/grads/"))
            loss, _, grads = train.value_and_grad(
                train.model_loss(cfg), local, batch, shards=shards)
            out[f"jax/{m}/own/loss"] = loss
            out.update(flat(grads, f"jax/{m}/own/grads/"))
    return out


# attention split by column (tests/test_torch_partition_attn_split.py):
# the kv-2 SMOKE configs on (data 1, model 4), a ring of 1024 slots (256 a
# rank: one chunk of the ring kernel's, so the card's staged ring, which
# the dry run counts on meta), int8 weights and ring; and a fake-mode train
# step of ChatGLM3's
ATTN_SPLIT_ARCHS = ("chatglm3-6b", "qwen2.5-32b")
ATTN_SPLIT_MESH, ATTN_SPLIT_MAX_LEN = (1, 4), 1024
ATTN_SPLIT_TRAIN = "chatglm3-6b"


def attn_split_quant(backend=None):
    from repro_torch.core.api import QuantConfig
    return QuantConfig(**part_quant("w8", 8), backend=backend)


def attn_split_train_config():
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    return smoke_config(ATTN_SPLIT_TRAIN).replace(quant=QuantConfig(
        w_bits=4, a_bits=8, attn_bits=7, mode="fake"))


def attn_split_job(rank, ref):
    """This rank's part of tests/test_torch_partition_attn_split.py on
    (data 1, model 4): each ATTN_SPLIT_ARCHS config's prefill and greedy
    ring steps on both backends over a 1024-slot ring (the rank's tree from
    ``partition.build_params``, seed 0; logits, fed tokens, its cache
    shard, the dispatch counts, and the bytes one more decode step sends);
    JAX's prefill cache carried into the rank's shard and decoded; and a
    fake-mode train step's loss and gradients."""
    import torch

    from repro_torch import interop
    from repro_torch import tree as tree_lib
    from repro_torch.configs.registry import smoke_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.models import lm

    toks = _tensors(ref, "tokens")["tokens"]
    mesh = make_mesh(ATTN_SPLIT_MESH)
    layout = partition.Layout.of(mesh, ("data",))
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True)
    out = {}
    for arch in ATTN_SPLIT_ARCHS:
        for backend in ("cuda", "torch"):
            cfg = smoke_config(arch).replace(quant=attn_split_quant(backend))
            local = partition.build_params(cfg, seed=0, layout=layout,
                                           device="cpu")
            key = f"{arch}/{backend}"
            dispatch.reset_stats()
            with use_rules(rules):
                logits, fed, cache = greedy(local, toks, cfg,
                                            max_len=ATTN_SPLIT_MAX_LEN)
                out[f"{key}/decode"] = torch.tensor(
                    dispatch.STATS[f"attention_decode_{backend}"])
                out.update(flat(cache, f"{key}/cache/"))
                col.reset_wire()
                lm.decode_step(local, fed[-1], tree_lib.tree_map(
                    torch.clone, cache), cfg)
            out.update({f"{key}/logits": logits, f"{key}/fed": fed,
                        f"{key}/wire": torch.tensor(
                            [col.WIRE["all_reduce"], col.WIRE["all_gather"],
                             col.WIRE["reduce_scatter"]])})
    # JAX's prefill cache, carried into the rank's slot shard
    cfg = smoke_config("qwen2.5-32b").replace(quant=attn_split_quant())
    local = partition.partition_params(_tree(ref, "jax/params"), cfg,
                                       layout)
    cache = interop.to_torch_shard(unflat(ref, "jax/cache"), cfg, layout,
                                   "cpu")
    with use_rules(rules):
        logits, fed = greedy_from(local, cache,
                                  torch.from_numpy(ref["jax/tok"]), cfg)
    out.update({"fromjax/logits": logits, "fromjax/fed": fed})
    # a fake-mode train step
    cfg = attn_split_train_config()
    layout = partition.Layout.of(mesh, ("data",), fsdp=True)
    local = partition.build_params(cfg, seed=0, layout=layout, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(
        "attn-split", cfg).items()}
    with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True,
                         expert_fsdp=True)):
        loss, _, grads = train.value_and_grad(
            train.model_loss(cfg), local, batch,
            shards=partition.opt_shards(local, cfg))
    out["train/loss"] = loss
    out.update(flat(grads, "train/grads/"))
    out[f"layout/{mesh_tag(ATTN_SPLIT_MESH)}"] = torch.tensor(
        [layout.index(("data",)), layout.index(("model",))])
    return out


def make_mesh(shape):
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(shape, ("data", "model"), device_type="cpu")


def launch(job, world, d, ref):
    """``world`` gloo ranks of ``job`` (this file's ``rank`` command), each
    logging to ``d``; join them with :func:`join`."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    store = d / f"{job}.store"
    procs = []
    for r in range(world):
        log = open(d / f"{job}-{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "rank", job, str(r), str(world),
             str(store), str(ref), str(d)], stdout=log,
            stderr=subprocess.STDOUT, env=env), log))
    return procs


def join(procs, d, job, timeout):
    """Wait for a job's ranks (each within ``timeout`` seconds, the rest
    killed); their outputs by rank."""
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    assert not bad, (job, bad, (d / f"{job}-{bad[0]}.log").read_text()[-3000:])
    return [load(d / f"{job}-{r}.npz") for r in range(len(procs))]


def rank_main(job, rank, world, store, ref_path, out_dir):
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        # "sp" and "sptrain" read their references once jaxsp and
        # jaxsptrain, beside them, have written them
        ref = load(ref_path) if job not in ("sp", "sptrain") else ref_path
        if job == "main":
            out = main_job(rank, world, ref)
        elif job == "partition":
            out = partition_job(ref)
        elif job == "families":
            out = families_job(ref)
        elif job == "train":
            sys.path.insert(0, ROOT)          # chip_smoke's code_flips
            out = train_job(rank, ref)
        elif job == "trainfam":
            sys.path.insert(0, ROOT)
            out = train_cases(ref, FAM_TRAIN_CASES)
        elif job == "shardlocal":
            sys.path.insert(0, ROOT)          # chip_smoke's A2ACount, wire
            out = shard_local_job(rank)
        elif job == "shardjax":
            sys.path.insert(0, ROOT)
            out = shard_jax_job(rank, ref)
        elif job == "dryrun":
            out = dryrun_job(rank)
        elif job == "attnsplit":
            out = attn_split_job(rank, ref)
        elif job == "sp":
            sys.path.insert(0, ROOT)          # chip_smoke's sp_wire_counts
            out = sp_job(rank, ref)
        elif job == "sptrain":
            sys.path.insert(0, ROOT)          # chip_smoke's FakeQuantTap
            out = sp_train_job(rank, ref)
        else:
            n = int(job[len("elastic"):])
            out = elastic_job(n, ref, os.path.join(out_dir, "elastic8-0.npz"))
        save(os.path.join(out_dir, f"{job}-{rank}.npz"), _np(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    if sys.argv[1] == "jax":
        jax_reference(sys.argv[2])
    elif sys.argv[1] == "jaxshard":
        jax_shard_bodies(sys.argv[3], sys.argv[2])
    elif sys.argv[1] == "jaxtrain":
        jax_train(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "jaxdryrun":
        jax_dryrun(sys.argv[2])
    elif sys.argv[1] == "jaxsp":
        jax_sp(sys.argv[2])
    elif sys.argv[1] == "jaxsptrain":
        jax_sp_train(sys.argv[2])
    else:
        job, rank, world, store, ref_path, out_dir = sys.argv[2:8]
        rank_main(job, int(rank), int(world), store, ref_path, out_dir)
