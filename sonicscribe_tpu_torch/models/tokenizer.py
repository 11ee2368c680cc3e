"""Tokenization and prompt assembly.

Two backends behind one interface:

- ``ByteTokenizer``: a self-contained reversible byte-level tokenizer
  (ids 7..262 = bytes 0..255, ids 0..6 = specials matching GlmAsrConfig).
  Used for tests, benches, and environments without a checkpoint.
- ``HFTokenizer``: thin adapter over a HuggingFace tokenizer loaded from the
  converted checkpoint directory (what production deployments use).

Prompt assembly mirrors the reference's chat template semantics
(reference: backend/asr.py:381-399 — a user message containing an audio slot
plus a text instruction, then the generation prompt) but builds token ids
directly; the audio slot is filled with projected encoder embeddings by the
engine rather than by a processor re-reading a temp WAV.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sonicscribe_tpu_torch.models.config import GlmAsrConfig

DEFAULT_INSTRUCTION = "Please transcribe this audio into text"


class ByteTokenizer:
    """Reversible byte-level tokenizer with 7 specials (see GlmAsrConfig)."""

    NUM_SPECIALS = 7

    def __init__(self, cfg: GlmAsrConfig | None = None):
        self.cfg = cfg or GlmAsrConfig()
        self.vocab_size = self.NUM_SPECIALS + 256

    def encode(self, text: str) -> list[int]:
        return [self.NUM_SPECIALS + b for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        data = bytes(
            int(i) - self.NUM_SPECIALS
            for i in ids
            if self.NUM_SPECIALS <= int(i) < self.NUM_SPECIALS + 256
        )
        return data.decode("utf-8", errors="replace")

    @property
    def eos_id(self) -> int:
        return self.cfg.eos_id

    @property
    def pad_id(self) -> int:
        return self.cfg.pad_id


class HFTokenizer:
    """Adapter over a HuggingFace tokenizer directory (lazy import)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, trust_remote_code=False)
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self._tok.decode(list(map(int, ids)), skip_special_tokens=True)

    @property
    def eos_id(self) -> int:
        return self._tok.eos_token_id

    @property
    def pad_id(self) -> int:
        pad = self._tok.pad_token_id
        # explicit None check: `or 0` treats a legitimate pad id of 0
        # correctly only by accident and silently remaps None
        return 0 if pad is None else int(pad)


def format_hotwords_prompt(hotwords: list[str] | None, max_hotwords: int = 10) -> str:
    """Hotword prompt-injection suffix, reference-parity semantics
    (reference: backend/asr.py:303-333): strip, dedupe case-insensitively,
    lowercase, cap at `max_hotwords`, render as
    '. Pay special attention to these important terms: "a", "b"'.
    """
    if not hotwords:
        return ""
    seen: set[str] = set()
    cleaned: list[str] = []
    for w in hotwords:
        w = str(w).strip().lower()
        if w and w not in seen:
            seen.add(w)
            cleaned.append(w)
        if len(cleaned) >= max_hotwords:
            break
    if not cleaned:
        return ""
    quoted = ", ".join(f'"{w}"' for w in cleaned)
    return f". Pay special attention to these important terms: {quoted}"


@dataclass
class Prompt:
    """Token ids surrounding the audio embedding slot."""

    prefix_ids: np.ndarray  # [P] tokens before the audio embeddings
    suffix_ids: np.ndarray  # [S] tokens after (instruction + generation prompt)

    @property
    def text_len(self) -> int:
        return len(self.prefix_ids) + len(self.suffix_ids)


_PROMPT_CACHE: dict = {}


def build_prompt(
    tokenizer,
    cfg: GlmAsrConfig,
    instruction: str = DEFAULT_INSTRUCTION,
    hotwords: list[str] | None = None,
) -> Prompt:
    """Assemble the chat-templated prompt around the audio slot:

        <bos><user><audio_start> [audio embeds] <audio_end> instruction <assistant>

    Cached: the continuous batcher builds a prompt PER ADMIT (50+/s under
    load) and tokenization was a measured chunk of admit host time.
    """
    key = (
        id(tokenizer),
        cfg.bos_id, cfg.user_id, cfg.audio_start_id, cfg.audio_end_id,
        cfg.assistant_id,
        instruction,
        tuple(hotwords) if hotwords else None,
    )
    hit = _PROMPT_CACHE.get(key)
    # the cached entry keeps a strong reference to its tokenizer and the hit
    # is identity-checked: id() alone could alias a NEW tokenizer allocated
    # at a garbage-collected one's address
    if hit is not None and hit[0] is tokenizer:
        # refresh recency: steady-state keys (the backlog's prompts, rebuilt
        # every scheduler tick) must survive adversarial hotword churn
        _PROMPT_CACHE[key] = _PROMPT_CACHE.pop(key)
        return hit[1]
    full = instruction + format_hotwords_prompt(hotwords)
    prefix = [cfg.bos_id, cfg.user_id, cfg.audio_start_id]
    suffix = [cfg.audio_end_id] + tokenizer.encode(full) + [cfg.assistant_id]
    prompt = Prompt(
        prefix_ids=np.asarray(prefix, np.int32),
        suffix_ids=np.asarray(suffix, np.int32),
    )
    if len(_PROMPT_CACHE) >= 4096:  # bound growth under adversarial hotwords
        # LRU eviction (hits re-insert, so dict order IS recency order): a
        # wholesale clear() would let one burst of unique hotword sets force
        # every backlogged request to re-tokenize on every subsequent tick
        _PROMPT_CACHE.pop(next(iter(_PROMPT_CACHE)))
    _PROMPT_CACHE[key] = (tokenizer, prompt)
    return prompt
