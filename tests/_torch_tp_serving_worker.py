"""One rank of tests/test_torch_tp_serving.py: serving and LoRA under tensor
parallelism in the port, at dp 2 x tp 2 on gloo over the CPU (four ranks).

    VISPER_COORDINATOR=localhost:<port> VISPER_NUM_PROCESSES=4 VISPER_PROCESS_ID=<rank> \\
        python tests/_torch_tp_serving_worker.py <workdir>

`<workdir>` holds what the test wrote: trees.pkl (the JAX package's trees
as numpy: `serve` tiny_test_vlm(distill=True), `wide` the same with the
attention and MLP widths int4 groups split over two ranks, `target` and
`draft` the bare decoders of tests/test_speculative.py, `lora` the LoRA
stage's VLM with a nonzero B, `moe` the MoE VLM, `wide_int4` the `wide`
tree with its decoder quantized to int4 by JAX, `wide_rms` JAX's act-RMS of
the `wide` decoder on the calibration batch) and inputs.npz (prompts, images, the
calibration batch, the LoRA stage's global batch, the MoE batch and its eos
ids). Each rank builds its tensor-parallel slices on the host
(`from_jax_params(..., tp=)`) and writes what it computed to rank<r>.pt.
Data coordinate 0 and 1 share the serving work (every case runs on both
ranks of one tensor-parallel group); the LoRA step and the MoE Generator
run on all four:

  engine     (data 0) the Engine's tokens and schedule counts in each of
             ENGINE_MODES, and a prefix-cache chain;
  quant      (data 0) quantize_decoder's int8 / int4 / AWQ buffers of the
             `wide` decoder, gathered whole (JAX's act-RMS for AWQ), the tp
             calibration's act-RMS, the Generator's tokens with each, and
             the buffers `from_jax_params` cut from JAX's int4 tree;
  spec       (data 1) SpeculativeDecoder with the draft at tp and whole,
             PromptLookupDecoder, sampling at tp and in one process, the
             warped probabilities of the prompt's last position, beam search;
  chat       (data 1) VisperModel chat / serve / ChatSession strings;
  lora       the LoRA stage at dp 2 x tp 2 (two remat policies): step-1
             gradients summed over the data group, 3 updates' metrics, the
             trainables after them; a checkpoint written at tp; the merged
             decoder's weights gathered whole;
  lora_world the LoRA step's gradients at dp 1 x tp 4, whose model group is
             the whole world (a stashed and a plain side path), and one
             process's on the whole model;
  moe        the MoE Generator's rows at dp 2 (whole model) and dp 2 x tp 2.
"""

import dataclasses
import os
import pickle
import sys
import time
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from visper_lm_tpu_torch import api as tapi  # noqa: E402
from visper_lm_tpu_torch import config as tconfig  # noqa: E402
from visper_lm_tpu_torch.data.collate import build_splice_plan  # noqa: E402
from visper_lm_tpu_torch.models.decoder import quantize_decoder  # noqa: E402
from visper_lm_tpu_torch.models.lora import apply_lora  # noqa: E402
from visper_lm_tpu_torch.parallel import distributed as D  # noqa: E402
from visper_lm_tpu_torch.parallel import tensor as T  # noqa: E402
from visper_lm_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from visper_lm_tpu_torch.serve import engine as teng  # noqa: E402
from visper_lm_tpu_torch.serve import speculative as tspec  # noqa: E402
from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder  # noqa: E402
from visper_lm_tpu_torch.serve.calibrate import decoder_act_rms  # noqa: E402
from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator  # noqa: E402
from visper_lm_tpu_torch.train import train_step as tts  # noqa: E402
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from visper_lm_tpu_torch.train.optimizer import OptimizerConfig  # noqa: E402
from visper_lm_tpu_torch.weights import decoder_from_jax_params, from_jax_params  # noqa: E402

OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1, stage="lora")
STEPS = 3
LORA = dict(r=4, alpha=8)
LORA_POLICIES = (None, "save_qkv_mlp")
# name -> (EngineConfig kwargs, max_new_tokens per request): tests/test_engine.py's
ENGINE_MODES = {
    "plain": (dict(num_slots=2), [6, 9, 4, 7, 5]),
    "kv_quant": (dict(num_slots=2, kv_quant=True), [6, 9, 4, 7, 5]),
    "w8a16": (dict(num_slots=2, kv_quant=True, weight_quant=True), [6, 9, 4, 7, 5]),
    "chunked_prefill": (dict(num_slots=2, prefill_chunk=64, prompt_bucket=64), [5, 4, 6, 5, 4]),
    "spec_quantum": (dict(num_slots=2, spec_k=4, spec_ngram=3, spec_quantum=3), [8, 6, 10, 7, 6]),
    "grouped": (dict(num_slots=4), [6, 5, 8, 4, 7]),
}
ENGINE_STATS = ("steps", "decoded_tokens", "slot_steps", "prefills", "spec_proposed",
                "spec_accepted", "group_admissions", "admit_dispatches")
QUANT_MODES = ("int8", "int4", "int4_awq")
PROMPT = [5, 17, 101, 33, 7]
REPEAT = [5, 17, 101, 33, 5, 17, 101, 33, 5, 17]
SPEC_TOKENS = 12
BEAMS = (2, 3)
SAMPLING = dict(temperature=0.8, top_p=0.9)
QUESTIONS = ("what is this", "describe the colors please", "how many things")
CHAT_IMAGES = ((40, 56), (64, 32), (28, 28))
MOE_CF = 0.5                      # a capacity factor that drops routes
MOE_NEW = 6


class StableTok:
    """A whitespace tokenizer with the HF surface the api uses that does not
    depend on the hash seed: a numeric word is its own id (so decode and
    re-encode round-trip, as the chat session's prefix reuse needs), the
    template's special tokens fixed ids, any other word 100 + crc32 % 400."""

    bos_token_id = 1
    eos_token_id = 2
    _SPECIALS = ("<|end|>", "<|eot_id|>", "</s>", "<|system|>", "<|user|>", "<|assistant|>",
                 "<|start_header_id|>", "<|end_header_id|>", "\n")

    def _words(self, text):
        import re

        parts = re.split("(" + "|".join(re.escape(s) for s in self._SPECIALS) + ")", text)
        words = []
        for p in parts:
            words.extend([p] if p in self._SPECIALS else [w for w in p.split(" ") if w])
        return words

    def __call__(self, text):
        ids = [self.bos_token_id]
        for w in self._words(text):
            if w in self._SPECIALS:
                ids.append(3 + self._SPECIALS.index(w))
            elif w.isdigit():
                ids.append(int(w))
            else:
                ids.append(100 + zlib.crc32(w.encode()) % 400)
        return type("Encoding", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(i) for i in ids)


def wide_config(C):
    """tiny_test_vlm(distill=True) with o_proj's and down_proj's input dims
    256: two int4 groups of 128, one on each of two ranks (C28)."""
    cfg = C.tiny_test_vlm(distill=True)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, head_dim=64,
                                                                mlp_dim=256))


def spec_configs(C):
    """tests/test_speculative.py's target (4 layers, width 64) and draft (2, 32)."""
    def make(layers, width):
        return C.DecoderConfig(vocab_size=256, hidden_size=width, num_layers=layers, num_heads=4,
                               num_kv_heads=2, head_dim=16, mlp_dim=width * 2, dtype="float32",
                               max_seq_len=512)

    return make(4, 64), make(2, 32)


def lora_config(C):
    return dataclasses.replace(C.tiny_test_vlm(distill=False), lora=C.LoraConfig(**LORA))


def moe_config(C):
    """tiny_test_vlm(distill=False) with JAX's dry-run MoE (E 4, top-2) at a
    capacity factor that drops routes."""
    cfg = C.tiny_test_vlm(distill=False)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, moe_experts=4, moe_top_k=2, moe_capacity_factor=MOE_CF))


def engine_plan(build, cfg, ids, max_len=256):
    return build(ids, None, max_len, num_image_tokens=cfg.num_image_tokens,
                 num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3)


def serve_engine(mod, build, weights, cfg, ids, images, kw, max_news, **extra):
    """One Engine run over the prompts: (tokens by uid, schedule counts)."""
    eng = mod.Engine(weights, cfg, mod.EngineConfig(max_len=512, **kw), None, **extra)
    done = eng.run([mod.Request(plan=engine_plan(build, cfg, ids[i]), images=images[i],
                                max_new_tokens=mn, uid=i) for i, mn in enumerate(max_news)])
    return {r.uid: r.output_ids for r in done}, {k: eng.stats.get(k, 0) for k in ENGINE_STATS}


def prefix_chain(mod, build, weights, cfg, inp, **extra):
    """tests/test_engine.py's prefix chain: a prefix with an image, a second
    turn over it, three suffixes over each handle."""
    eng = mod.Engine(weights, cfg, mod.EngineConfig(num_slots=2, max_len=512), None, **extra)
    handle = eng.prefill_prefix(engine_plan(build, cfg, inp["prefix_ids"].tolist(), 128),
                                images=inp["prefix_image"])
    h2 = eng.prefill_prefix(engine_plan(build, cfg, inp["turn2"].tolist(), 64), prefix=handle)
    suffixes = [inp[f"suffix{i}"].tolist() for i in range(3)]
    done = eng.run([mod.Request(plan=engine_plan(build, cfg, s), prefix=h, max_new_tokens=6,
                                uid=(i, j))
                    for i, s in enumerate(suffixes) for j, h in enumerate((handle, h2))])
    return {r.uid: r.output_ids for r in done}, eng.stats["prefills"]


def chat_images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in CHAT_IMAGES]


def chat_all(model):
    """chat, serve (w8a16 too) and a three-turn ChatSession of a VisperModel."""
    images = chat_images()
    out = dict(chat=model.chat(list(QUESTIONS), images, max_new_tokens=5),
               serve=model.serve(list(QUESTIONS), images, max_new_tokens=5, num_slots=2),
               chat_w8=model.chat(list(QUESTIONS), images, max_new_tokens=5, weight_quant=True))
    session = model.chat_session(images[0])
    out["session"] = [session.ask(q, max_new_tokens=3) for q in QUESTIONS]
    out["session_ids"] = list(session._ids)
    return out


def gather_buffers(decoder) -> dict:
    """Every QuantLinear buffer of a tp decoder, whole (collective)."""
    return {n: T.whole_param(decoder, n, b) for n, b in decoder.named_buffers()}


def run_engine(trees, inp, cfg, tp) -> dict:
    model = from_jax_params(trees["serve"], cfg, device="cpu", tp=tp)
    ids = [inp[f"engine_ids{i}"].tolist() for i in range(5)]
    images = [inp[f"engine_image{i}"] for i in range(5)]
    out = {mode: serve_engine(teng, build_splice_plan, model, cfg, ids, images, kw, mn,
                              device="cpu")
           for mode, (kw, mn) in ENGINE_MODES.items()}
    out["prefix"] = prefix_chain(teng, build_splice_plan, model, cfg, inp, device="cpu")
    eng = teng.Engine(model, cfg, teng.EngineConfig(num_slots=2, max_len=512), device="cpu")
    out["cache_heads"] = eng.cache.k.shape[3]
    return out


def run_quant(trees, inp, tp, data_rows) -> dict:
    cfg = wide_config(tconfig)
    model = from_jax_params(trees["wide"], cfg, device="cpu", tp=tp)
    rms_j = {k: torch.from_numpy(np.array(v)) for k, v in trees["wide_rms"].items()}
    out = {"rms_tp": decoder_act_rms(model.decoder, cfg.decoder,
                                     [torch.from_numpy(np.array(inp["calib"]))])}
    gen = {k[4:]: inp[k][data_rows] for k in inp.files if k.startswith("gen_")}
    for mode in QUANT_MODES:
        rms = rms_j if mode == "int4_awq" else None
        qdec = quantize_decoder(model.decoder, mode[:4], act_rms=rms)
        out[mode] = dict(
            buffers=gather_buffers(qdec),
            local={n: tuple(b.shape) for n, b in qdec.named_buffers()},
            tokens=Generator(model, cfg, GenerationConfig(
                max_new_tokens=5, weight_quant=mode[:4], calibration=rms), 2, 64,
                cache_dtype=torch.float32, device="cpu").generate(dict(gen)))
    loaded = from_jax_params(trees["wide_int4"], cfg, device="cpu", tp=tp).decoder
    out["loaded_int4"] = {n: b.clone() for n, b in loaded.named_buffers()}
    out["int4_local"] = {n: b.clone() for n, b in quantize_decoder(
        model.decoder, "int4").named_buffers()}
    return out


def run_spec(trees, tp) -> dict:
    tcfg, dcfg = spec_configs(tconfig)
    target = decoder_from_jax_params(trees["target"], tcfg, device="cpu", tp=tp)
    whole_target = decoder_from_jax_params(trees["target"], tcfg, device="cpu")
    drafts = dict(tp=decoder_from_jax_params(trees["draft"], dcfg, device="cpu", tp=tp),
                  whole=decoder_from_jax_params(trees["draft"], dcfg, device="cpu"))
    kw = dict(max_len=512, cache_dtype=torch.float32)
    out = {"greedy": tspec.greedy_reference_ids(target, PROMPT, max_new_tokens=SPEC_TOKENS, **kw)}
    for name, draft in drafts.items():
        ids, st = tspec.SpeculativeDecoder(target, draft, k=4, **kw).generate(
            PROMPT, max_new_tokens=SPEC_TOKENS)
        out[f"spec_{name}"] = (ids, st.accepted, st.iterations)
    ids, st = tspec.PromptLookupDecoder(target, k=4, ngram=3, **kw).generate(
        REPEAT, max_new_tokens=SPEC_TOKENS)
    out["lookup"] = (ids, st.accepted, st.iterations)
    for name, t in (("tp", target), ("one", whole_target)):
        ids, _ = tspec.SpeculativeDecoder(t, drafts["whole"], k=4, **kw, **SAMPLING).generate(
            PROMPT, max_new_tokens=SPEC_TOKENS, seed=3)
        out[f"sampled_{name}"] = ids
    toks = torch.as_tensor([PROMPT])
    logits = target(target.embed(toks))["logits"][0, -1]
    out["warped"] = tspec.warp_probs(logits, SAMPLING["temperature"], SAMPLING["top_p"])
    for beams in BEAMS:
        out[f"beam{beams}"] = BeamSearchDecoder(target, num_beams=beams, **kw).generate(
            PROMPT, max_new_tokens=6, eos_token_ids=(7,))
    return out


def run_lora(trees, inp, mesh, tp, data_rows, workdir) -> dict:
    cfg = lora_config(tconfig)
    batch = {k[5:]: inp[k][data_rows] for k in inp.files if k.startswith("lora_")}
    local = D.shard_batch_multihost(batch, mesh)
    out = {}
    for policy in LORA_POLICIES:
        step = tts.make_train_step(cfg, OptimizerConfig(**OPT), from_jax_params(
            trees["lora"], cfg, device="cpu", tp=tp), mesh=mesh, remat_policy=policy)
        met, grads = step.loss_and_grads(local)
        for n in sorted(grads):
            D.all_reduce(grads[n], step.zero.group)
        metrics = [step(local) for _ in range(STEPS)]
        out[policy] = dict(met={k: float(v) for k, v in zip(met, D.all_reduce_scalars(
            list(met.values()), step.zero.group))}, grads=grads, metrics=metrics,
            trainables={n: p.detach().clone() for n, p in step.trainable.items()})
        if policy is None:
            CheckpointManager(os.path.join(workdir, "lora_ckpt")).save(STEPS, step, cfg)
            out["state"] = {k: v.detach().clone() for k, v in step.state_tensors().items()}
        del step
    merged = apply_lora(from_jax_params(trees["lora"], cfg, device="cpu", tp=tp))
    out["merged"] = {n: T.whole_param(merged.decoder, n, p.detach())
                     for n, p in merged.decoder.named_parameters() if ".blocks." in f".{n}"}
    return out


def run_lora_world(trees, inp) -> dict:
    """The LoRA step's gradients at dp 1 x tp 4 (the model group is the
    default group) against one process's, on the LoRA config with 4 kv
    heads."""
    cfg = lora_config(tconfig)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_kv_heads=4))
    mesh = make_mesh(dp=1, tp=4)
    tp = T.tensor_parallel(mesh)
    batch = {k[5:]: inp[k] for k in inp.files if k.startswith("lora_")}
    out = {}
    for policy in LORA_POLICIES:
        grads = {}
        for name, group in (("tp4", tp), ("one", None)):
            model = from_jax_params(trees["lora_kv4"], cfg, device="cpu", tp=group)
            step = tts.make_train_step(cfg, OptimizerConfig(**OPT), model, remat_policy=policy,
                                       mesh=mesh if group is not None else None)
            data = D.shard_batch_multihost(batch, mesh) if group is not None else batch
            grads[name] = step.loss_and_grads(data)[1]
        out[policy] = grads
    return out


def run_moe(trees, inp, tp, data) -> dict:
    cfg = moe_config(tconfig)
    rows = slice(data.rank * 2, data.rank * 2 + 2)
    batch = {k[4:]: inp[k][rows] for k in inp.files if k.startswith("moe_")}
    gen_cfg = GenerationConfig(max_new_tokens=MOE_NEW, decode_chunk=2,
                               eos_token_ids=tuple(int(t) for t in inp["moe_eos"]))
    out = {}
    for name, group in (("dp2", None), ("dp2_tp2", tp)):
        model = from_jax_params(trees["moe"], cfg, device="cpu", tp=group)
        gen = Generator(model, cfg, gen_cfg, 2, 64, cache_dtype=torch.float32, device="cpu",
                        data=data)
        emb = gen._to_device(dict(batch))
        out[name] = dict(tokens=gen.generate(dict(batch)))
        if name == "dp2":
            out[name]["local_tokens"] = Generator(model, cfg, gen_cfg, 2, 64,
                                                  cache_dtype=torch.float32,
                                                  device="cpu").generate(dict(batch))
            out[name]["dropped"] = float(moe_prefill_dropped(gen, emb))
    return out


def moe_prefill_dropped(gen, batch) -> torch.Tensor:
    """The global batch's dropped share in the Generator's prefill."""
    from visper_lm_tpu_torch.models.vlm import encode_images, splice_embeddings

    embeds = splice_embeddings(gen.model, batch["text_ids"].long(), batch["token_type"],
                               batch["src_index"].long(), encode_images(gen.model, batch["images"]))
    offsets = batch["pad_offsets"].long()
    out = gen.decoder(embeds, kv_starts=offsets, compute_logits=False, moe_data=gen.moe_data)
    return out["moe_aux"]["dropped_frac"]


def main(workdir: str) -> None:
    t0 = time.perf_counter()
    D.init_distributed(device="cpu")
    rank = D.process_index()
    mesh = make_mesh(dp=2, tp=2)
    tp = T.tensor_parallel(mesh)
    data_index, _ = D.data_shard(mesh)
    data = D.AxisGroup(*D.data_group(mesh))
    with open(os.path.join(workdir, "trees.pkl"), "rb") as f:
        trees = pickle.load(f)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    rows = slice(data_index * 2, data_index * 2 + 2)
    out = dict(coords=mesh.coords(rank), seconds={})

    def timed(name, fn, *a):
        s = time.perf_counter()
        out[name] = fn(*a)
        out["seconds"][name] = time.perf_counter() - s

    cfg = tconfig.tiny_test_vlm(distill=True)
    with torch.no_grad():
        if data_index == 0:
            timed("engine", run_engine, trees, inp, cfg, tp)
            timed("quant", run_quant, trees, inp, tp, rows)
        else:
            timed("spec", run_spec, trees, tp)
            model = tapi.VisperModel(cfg=cfg, model=from_jax_params(
                trees["serve"], cfg, device="cpu", tp=tp), tokenizer=StableTok(), context_len=256)
            timed("chat", chat_all, model)
    timed("lora", run_lora, trees, inp, mesh, tp, rows, workdir)
    timed("lora_world", run_lora_world, trees, inp)
    with torch.no_grad():
        timed("moe", run_moe, trees, inp, tp, data)
    out["seconds"]["total"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    D.barrier()
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
