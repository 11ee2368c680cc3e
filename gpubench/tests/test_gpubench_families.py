"""Model families: the glm_asr family gives the harness what it had before,
bit for bit, and a family added as files alone runs through a whole cell."""

from __future__ import annotations

import json
import math
import shutil
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpubench import harness, manifest, system
from gpubench.reference import check, frontend, model
from gpubench.reference.quant import quantize_tree
from gpubench.reference.weights import QUANT_LEAVES, make_weights
from gpubench.tests.tiny import tiny_cell, tiny_config
from gpubench.traffic import synth

GLM_ASR = manifest.family("glm_asr")
SEEDS = (2**31 + 41, 7)
FIXTURE = manifest.HERE / "tests" / "fixtures" / "glm_asr_streamed.py"


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_trees_equal(a: dict, b: dict) -> None:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def _int8(cfg: dict) -> dict:
    return dict(cfg, weight_bits=8, quantized_leaves=list(QUANT_LEAVES))


# The judging path as it ran before model families, kept here as the yardstick:
# check.reference_weights and model.served_logits over the whole tree, the
# decoder's loop indexing the stacked leaves.

def _old_reference_weights(cfg, seed, device, bits=None):
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]

    def f32(node):
        return {k: f32(v) for k, v in node.items()} if isinstance(node, dict) else node.float()

    W = f32(make_weights(cfg["model"], seed, device, dtype))
    if bits is not None:
        return quantize_tree(W, bits, QUANT_LEAVES)
    if cfg["weight_bits"] < 16:
        W = quantize_tree(W, cfg["weight_bits"], tuple(cfg["quantized_leaves"]))
    return W


def _old_decoder_logits(W, m, embeds, at):
    dec = m["decoder"]
    p = W["decoder"]
    L = p["layers"]
    S = embeds.shape[0]
    nh, nkv, hd, eps = dec["n_heads"], dec["n_kv_heads"], dec["head_dim"], dec["rms_eps"]
    pos = torch.arange(S, device=embeds.device)
    mask = torch.full((S, S), float("-inf"), device=embeds.device).triu(1)
    x = embeds.float()
    for i in range(dec["n_layers"]):
        h = model._rms(x, L["ln1_scale"][i], eps)
        qkv = h @ L["qkv_w"][i].float() + L["qkv_b"][i].float()
        q = model._rope(qkv[:, : nh * hd].view(S, nh, hd), pos, dec)
        k = model._rope(qkv[:, nh * hd : (nh + nkv) * hd].view(S, nkv, hd), pos, dec)
        v = qkv[:, (nh + nkv) * hd :].view(S, nkv, hd)
        k = k.repeat_interleave(nh // nkv, dim=1).transpose(0, 1)
        v = v.repeat_interleave(nh // nkv, dim=1).transpose(0, 1)
        att = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(hd) + mask
        ctx = (torch.softmax(att, dim=-1) @ v).transpose(0, 1).reshape(S, nh * hd)
        x = x + ctx @ L["o_w"][i].float()
        h = model._rms(x, L["ln2_scale"][i], eps)
        gate, up = (h @ L["gate_up_w"][i].float()).chunk(2, dim=-1)
        x = x + (F.silu(gate) * up) @ L["down_w"][i].float()
    h = model._rms(x[at], p["ln_f_scale"], eps)
    return h @ p["embed"].float().T


def _old_served_logits(W, m, mel, prefix, suffix, tokens):
    emb = W["decoder"]["embed"].float()
    audio = model.encode(W, m, mel)
    ids = lambda xs: torch.as_tensor(list(xs), dtype=torch.long)  # noqa: E731
    embeds = torch.cat([emb[ids(prefix)], audio, emb[ids(suffix)], emb[ids(tokens[:-1])]])
    first = len(prefix) + audio.shape[0] + len(suffix) - 1
    return _old_decoder_logits(W, m, embeds, torch.arange(first, first + len(tokens)))


def _old_gaps(cfg, seed, requests, device, control=False):
    check.strict_float32()
    prefix, suffix = check.prompt_ids(cfg)
    W = _old_reference_weights(cfg, seed, device)
    Wc = _old_reference_weights(cfg, seed, device, check.control_bits(cfg)) if control else None
    gaps_, margins, gaps_c = [], [], []
    for req in requests:
        toks = [int(t) for t in req["tokens"]]
        if not toks:
            continue
        mel = check.request_mel(cfg, req, device)
        ref = _old_served_logits(W, cfg["model"], mel, prefix, suffix, toks)
        top2 = ref.topk(2, dim=1).values
        best = top2[:, 0]
        margins.append((top2[:, 0] - top2[:, 1]).cpu())
        served = ref.gather(1, torch.as_tensor(toks)[:, None])[:, 0]
        gaps_.append((best - served).cpu())
        if Wc is not None:
            pick = _old_served_logits(Wc, cfg["model"], mel, prefix, suffix, toks).argmax(dim=1)
            gaps_c.append((best - ref.gather(1, pick[:, None])[:, 0]).cpu())
    cat = lambda xs: torch.cat(xs) if xs else torch.zeros(0)  # noqa: E731
    gap, margin = cat(gaps_), cat(margins)
    readings = check._calibration if control else check._per_tie
    out = dict(readings(gap, margin), tokens=int(gap.numel()), requests=len(requests))
    if control:
        gc = cat(gaps_c)
        out["control"] = check._calibration(gc, margin)
        out["positions"] = [[round(float(a), 5), round(float(b), 5), round(float(c), 5)]
                            for a, b, c in zip(margin, gap, gc)]
    return out


def _requests(cfg: dict, seed: int) -> list:
    """Three file requests and one ring request, served tokens drawn at random
    (the comparison reads any tokens; these put some far from the best)."""
    rng = np.random.default_rng([seed, 3])
    vocab = cfg["model"]["decoder"]["vocab_size"]
    out = []
    for seconds in (0.7, 1.6, 2.3):
        pcm = synth.to_pcm16(synth.speech_tape(rng, seconds))
        out.append({"path": "file", "pcm": pcm,
                    "tokens": rng.integers(0, vocab, size=int(rng.integers(4, 20))).tolist()})
    pcm = synth.to_pcm16(synth.speech_tape(rng, 1.0))[: 13 * 1024]
    bucket = frontend.chunk_bucket(13, cfg["serving"]["app"]["prefill_buckets"], 1024, 160)
    out.append({"path": "ring", "pcm": pcm, "bucket_samples": bucket * 1024,
                "tokens": rng.integers(0, vocab, size=9).tolist()})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_glm_asr_familys_trees_are_the_old_ones(seed, dtype):
    cfg = tiny_config()
    m = cfg["model"]
    _assert_trees_equal(GLM_ASR.make_weights(m, seed, "cpu", dtype),
                        make_weights(m, seed, "cpu", dtype))
    for c, bits in ((cfg, None), (cfg, 8), (_int8(cfg), None), (_int8(cfg), 4)):
        _assert_trees_equal(GLM_ASR.reference(c, seed, "cpu", bits=bits).W,
                            _old_reference_weights(c, seed, "cpu", bits))


@pytest.mark.parametrize("weights", ["native", "int8"])
@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_gaps_through_the_family_equal_the_old_path(seed, control, weights):
    cfg = tiny_config() if weights == "native" else _int8(tiny_config())
    reqs = _requests(cfg, seed)
    new = check.gaps(GLM_ASR, cfg, seed, reqs, "cpu", control=control)
    old = _old_gaps(cfg, seed, reqs, "cpu", control=control)
    assert new == old
    assert new["tokens"] > 30 and new["gap_per_tie"] > 0


def _streamed_tree(tmp_path):
    """A copy of the benchmark with the fixture family, its tiny configuration,
    workload file and cell entry added: files only."""
    shutil.copytree(manifest.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    g = tmp_path / "gpubench"
    shutil.copy(FIXTURE, g / "families" / "glm_asr_streamed.py")
    cfg = dict(tiny_config(), name="tiny-streamed", family="glm_asr_streamed")
    (g / "configs" / "tiny-streamed.json").write_text(json.dumps(cfg))
    shutil.copy(g / "workloads" / "nano-bf16.files-novad.json",
                g / "workloads" / "tiny-streamed.files-novad.json")
    man = manifest.manifest()
    man["configs"].append({"name": "tiny-streamed", "source": "https://example.org/tiny",
                           "file": "gpubench/configs/tiny-streamed.json", "reduced": [],
                           "why": "a family added by files alone"})
    man["workloads"].append({"name": "tiny-streamed.files-novad", "config": "tiny-streamed",
                             "traffic": "files-novad", "chips": 1, "why": "the fixture family"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "nano-bf16.files-novad" in m.get("workloads", ()):
            m["workloads"].append("tiny-streamed.files-novad")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp_path


def test_a_family_added_by_files_only_runs_a_cell_correct(tmp_path, monkeypatch):
    root = _streamed_tree(tmp_path)
    cell = tiny_cell("tiny-streamed.files-novad", root)
    assert cell.config["family"] == "glm_asr_streamed"
    assert cell.family().__name__ == "gpubench_family_glm_asr_streamed"
    built = {}
    build = system.build

    def kept(cfg, family, seed, device):
        out = build(cfg, family, seed, device)
        built.update(params=out[0].transcriber.params, family=family, seed=seed)
        return out

    monkeypatch.setattr(system, "build", kept)
    res = harness.run_cell(cell, 2**31 + 123, 3.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["tokens_compared"]["value"] >= 10
    # the program served the family's tree (at tiny size the comparison alone cannot
    # tell one random tree from another: each position's best logit is its input token's)
    given = built["family"].make_weights(cell.config["model"], built["seed"], "cpu",
                                         torch.float32)
    held = dict(_leaves(built["params"]))
    for path, leaf in _leaves(given):
        assert torch.equal(held[path], leaf), path


@pytest.mark.parametrize("seed", SEEDS)
def test_the_layer_by_layer_reference_is_the_whole_tree_pass(tmp_path, seed):
    fam = manifest.family("glm_asr_streamed", _streamed_tree(tmp_path))
    cfg = tiny_config()
    m = cfg["model"]
    tree = fam.make_weights(m, seed, "cpu", torch.float32)
    # its own weights: every leaf from its own seed, not glm_asr's draw
    assert not torch.equal(tree["decoder"]["embed"],
                           make_weights(m, seed, "cpu", torch.float32)["decoder"]["embed"])
    whole = GLM_ASR.Reference(GLM_ASR._to_f32(tree), m)
    ref = fam.reference(cfg, seed, "cpu")
    assert "layers" not in ref.W["decoder"]
    prefix, suffix = check.prompt_ids(cfg)
    reqs = _requests(cfg, seed)
    for req in reqs:
        mel = check.request_mel(cfg, req, "cpu")
        a = ref.served_logits(mel, prefix, suffix, req["tokens"])
        b = whole.served_logits(mel, prefix, suffix, req["tokens"])
        assert (a - b).abs().max().item() <= 1e-6
    assert ref.layers_made == m["decoder"]["n_layers"] * len(reqs)
