"""AutoInference, the user-facing host API (port of
vsim_tpu/api/interface.py; the reference's cformers/interface.py), in
process: the port's InferenceEngine on the CUDA card, the streaming hooks
plain callbacks.

    ai = AutoInference("OpenAssistant/oasst-sft-1-pythia-12b")
    out = ai.generate("Hello", num_tokens_to_generate=100, top_k=20,
                      top_p=0.95, temperature=0.85, seed=42,
                      streaming_token_str_hook=print)
    out["token_str"]

Model sources, in order:
  1. ``model_path=``: a checkpoint directory (``convert/store.py``) or a
     reference ggml .bin;
  2. the local download cache (``$VSIM_TPU_CACHE_PATH``, default
     ``~/.cformers``, the reference's cache, interface.py:16-19);
  3. the registry URL (the reference's published int4_fixed_zero files,
     sha256-checked as interface.py:21-47 does).

The engine runs on the card unless ``device="cpu"`` is given; with no card
and no device named, the constructor raises.  The tokenizer is HF's where
transformers is installed and knows the model, else the vocab table of the
model file (``VocabTokenizer``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

from vsim_tpu_torch.device import DeviceLike, resolve_device

CACHE_PATH = os.environ.get(
    "VSIM_TPU_CACHE_PATH",
    os.environ.get("CFORMERS_CACHE_PATH",
                   os.path.join(os.path.expanduser("~"), ".cformers")),
)


@dataclasses.dataclass
class ModelUrlMap:
    """A registry entry (the reference's interface.py:49-89)."""

    cpp_model_name: str  # arch: gptneox | gptj | bloom | gpt2
    int4_fixed_zero: str = ""
    sha256: str = ""

    def get_url(self, mode: str) -> str:
        if mode != "int4_fixed_zero" or not self.int4_fixed_zero:
            raise ValueError(
                f"mode {mode!r} not available; modes: {self.get_modes()}")
        return self.int4_fixed_zero

    def get_modes(self) -> List[str]:
        return ["int4_fixed_zero"] if self.int4_fixed_zero else []


# the models the reference registers (interface.py:92-143)
MAP_MODEL_TO_URL: Dict[str, ModelUrlMap] = {
    "EleutherAI/gpt-j-6B": ModelUrlMap(
        "gptj",
        "https://huggingface.co/ayushk4/EleutherAI-.-gpt-j-6B/resolve/main/int4_fixed_zero.bin"),
    "Salesforce/codegen-350M-mono": ModelUrlMap(
        "gptj",
        "https://huggingface.co/jncraton/Salesforce-.-codegen-350M-mono/resolve/main/int4_fixed_zero.bin"),
    "Salesforce/codegen-2B-mono": ModelUrlMap(
        "gptj",
        "https://huggingface.co/ayushk4/Salesforce-.-codegen-2B-mono/resolve/main/int4-fixed-zero.bin"),
    "Salesforce/codegen-6B-mono": ModelUrlMap(
        "gptj",
        "https://huggingface.co/ayushk4/Salesforce-.-codegen-6B-mono/resolve/main/int4-fixed-zero.bin"),
    "Salesforce/codegen-16B-mono": ModelUrlMap(
        "gptj",
        "https://huggingface.co/kamalojasv/Salesforce-.-codegen-16B-mono/resolve/main/int4-fixed-zero"),
    "bigscience/bloom-560m": ModelUrlMap(
        "bloom",
        "https://huggingface.co/tejasvaidhya/bloom-560m-4bit-quant.bin/resolve/main/int4_fixed_zero.bin"),
    "bigscience/bloom-1b1": ModelUrlMap(
        "bloom",
        "https://huggingface.co/tejasvaidhya/bloom-1b1-4bit-quant.bin/resolve/main/int4_fixed_zero.bin"),
    "bigscience/bloom-1b7": ModelUrlMap(
        "bloom",
        "https://huggingface.co/tejasvaidhya/bloom-1b7-4bit-quant.bin/resolve/main/int4_fixed_zero.bin"),
    "bigscience/bloom-3b": ModelUrlMap(
        "bloom",
        "https://huggingface.co/tejasvaidhya/bloom-3b-4bit-quant.bin/resolve/main/int4_fixed_zero.bin"),
    "bigscience/bloom-7b1": ModelUrlMap(
        "bloom",
        "https://huggingface.co/ayushk4/bigscience-.-bloom-7b1/resolve/main/int4_fixed_zero.bin"),
    "gpt2": ModelUrlMap(
        "gpt2",
        "https://huggingface.co/kamalojasv/gpt2/resolve/main/int4_fixed_zero"),
    "togethercomputer/GPT-NeoXT-Chat-Base-20B": ModelUrlMap(
        "gptneox",
        "https://huggingface.co/Black-Engineer/OpenChatKit_q4/resolve/main/int4_fixed_zero"),
    "OpenAssistant/oasst-sft-1-pythia-12b": ModelUrlMap(
        "gptneox",
        "https://huggingface.co/ayushk4/OpenAssistant-.-oasst-sft-1-pythia-12b/resolve/main/int4_fixed_zero.bin"),
    "stabilityai/stablelm-tuned-alpha-7b": ModelUrlMap(
        "gptneox",
        "https://huggingface.co/cakewalk/ggml-q4_0-stablelm-tuned-alpha-7b/resolve/main/ggml-model-stablelm-tuned-alpha-7b-q4_0.bin"),
}


class VocabTokenizer:
    """A tokenizer from the vocab table of the model file itself.

    The reference loads the vocab from the ggml binary (vsim.cpp:127-174)
    and tokenizes by greedy longest-prefix match (gpt_tokenize,
    utils.cpp:192-237).  So does this: ``decode`` joins the raw vocab
    bytes, ``encode`` takes the longest vocab entry at each position.  BPE
    merges (rank tie-breaking) are not replicated; HF's tokenizer is used
    where it can be.
    """

    def __init__(self, vocab: Sequence[bytes]):
        self.vocab: List[bytes] = [bytes(t) for t in vocab]
        self._index: Dict[bytes, int] = {}
        for i, tok in enumerate(self.vocab):
            # the first occurrence wins (some vocabs repeat a string)
            self._index.setdefault(tok, i)
        self._max_len = max((len(t) for t in self.vocab if t), default=1)

    def decode(self, ids: Sequence[int]) -> str:
        buf = b"".join(
            self.vocab[i] for i in ids if 0 <= int(i) < len(self.vocab))
        return buf.decode("utf-8", errors="replace")

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        out: List[int] = []
        pos = 0
        while pos < len(data):
            for ln in range(min(self._max_len, len(data) - pos), 0, -1):
                tok = self._index.get(data[pos: pos + ln])
                if tok is not None:
                    out.append(tok)
                    pos += ln
                    break
            else:
                pos += 1  # an unmappable byte is skipped, as utils.cpp does
        return out


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _download(url: str, dest: str) -> None:
    """Resumable, atomic download: the bytes stream to ``dest + '.part'``
    (a Range request picks up where an interrupted run stopped), and only
    the os.replace of the whole file creates ``dest``, so an interrupted
    download never leaves a cut file at the final path (the reference
    urlretrieves straight to it, interface.py:156-170)."""
    import urllib.error
    import urllib.request

    os.makedirs(os.path.dirname(dest), exist_ok=True)
    part = dest + ".part"
    offset = os.path.getsize(part) if os.path.exists(part) else 0
    req = urllib.request.Request(url)  # nosec: a user-requested file
    if offset:
        req.add_header("Range", f"bytes={offset}-")
        print(f"resuming {url} at {offset / 1e6:.1f} MB")
    else:
        print(f"downloading {url} → {dest}")
    try:
        resp = urllib.request.urlopen(req)  # nosec
    except urllib.error.HTTPError as e:
        if offset and e.code == 416:  # range not satisfiable: complete
            os.replace(part, dest)
            return
        raise
    with resp:
        mode = "ab" if offset and resp.status == 206 else "wb"
        done = offset if mode == "ab" else 0
        next_report = done + (64 << 20)
        with open(part, mode) as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                if done >= next_report:
                    print(f"  ... {done / 1e9:.2f} GB", flush=True)
                    next_report = done + (64 << 20)
    os.replace(part, dest)


class AutoInference:
    """The reference's AutoInference (interface.py:145) over the port's
    InferenceEngine."""

    def __init__(
        self,
        model_name: str,
        mode: str = "int4_fixed_zero",
        *,
        model_path: Optional[str] = None,
        hf_model=None,
        tokenizer=None,
        n_ctx: int = 2048,
        batch: int = 1,
        from_pretrained_kwargs: Optional[dict] = None,
        device: DeviceLike = None,
        kv_dtype: Optional[str] = None,
        compute_dtype: Optional[str] = None,
    ):
        """``device``: the card unless another is named.  ``kv_dtype``: the
        decode cache's ("float32", the config's default, "int8" or "int4",
        the dtypes K3 and K6 serve).  ``compute_dtype``: the activations'
        ("float32", the config's default, or "bfloat16", whose one-token
        matmuls take K1)."""
        from vsim_tpu_torch.engine.generate import InferenceEngine

        self.device = resolve_device(device)
        self.model_name = model_name
        self.mode = mode
        self.vocab: Optional[List[bytes]] = None

        if hf_model is not None:  # an HF model object (tests, offline)
            from vsim_tpu_torch.convert.hf import convert_hf_model

            cfg, params = convert_hf_model(hf_model, n_ctx=n_ctx,
                                           device=self.device)
        else:
            if model_path is None:
                model_path = self._resolve_model_path()
            cfg, params, self.vocab = self._load(model_path, n_ctx)

        if compute_dtype is not None:
            cfg = cfg.replace(compute_dtype=compute_dtype)
        self.config = cfg
        self.engine = InferenceEngine(cfg, params, n_ctx=n_ctx,
                                      kv_dtype=kv_dtype, device=self.device)
        self.tokenizer = tokenizer if tokenizer is not None else \
            self._default_tokenizer(from_pretrained_kwargs)

    def _default_tokenizer(self, from_pretrained_kwargs):
        """HF's tokenizer for the model; without transformers, or where it
        cannot load one, the vocab table of the model file (the reference's,
        vsim.cpp:127-174), or None for a source without one."""
        try:
            from transformers import AutoTokenizer

            os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
            return AutoTokenizer.from_pretrained(
                self.model_name, **(from_pretrained_kwargs or {}))
        except (ImportError, OSError):
            return VocabTokenizer(self.vocab) if self.vocab else None

    # -- model resolution ----------------------------------------------------

    def _resolve_model_path(self) -> str:
        entry = MAP_MODEL_TO_URL.get(self.model_name)
        if entry is None:
            raise ValueError(
                f"unknown model {self.model_name!r}; known: "
                f"{sorted(MAP_MODEL_TO_URL)} (or pass model_path=)")
        local = os.path.join(
            CACHE_PATH, "models", self.model_name.replace("/", "-.-"),
            self.mode)
        pin = local + ".sha256"
        fresh = not os.path.exists(local)
        if fresh:
            _download(entry.get_url(self.mode), local)
        digest = _sha256(local)
        if entry.sha256:  # a published hash (reference interface.py:21-47)
            if digest != entry.sha256:
                print(f"WARNING: sha256 mismatch for {local} — file may be "
                      f"corrupt or outdated")  # warn only, as the reference
        elif fresh or not os.path.exists(pin):
            # no published hash: pin the first digest seen, so that a later
            # load finds a corrupted cache
            with open(pin, "w") as f:
                f.write(digest + "\n")
        else:
            with open(pin) as f:
                pinned = f.read().strip()
            if digest != pinned:
                print(f"WARNING: sha256 of {local} changed since first "
                      f"download ({digest[:12]}… vs pinned {pinned[:12]}…) — "
                      f"cached file may be corrupt; delete it (and the "
                      f".sha256 pin) to re-download")
        return local

    def _load(self, path: str, n_ctx: int):
        if os.path.isdir(path):  # a checkpoint directory
            from vsim_tpu_torch.convert.store import load_params

            cfg, params = load_params(path, device=self.device)
            return cfg.replace(n_ctx=max(cfg.n_ctx, n_ctx)), params, None
        from vsim_tpu_torch.convert.ggml_file import load_ggml_model

        entry = MAP_MODEL_TO_URL.get(self.model_name)
        arch = entry.cpp_model_name if entry else "gptneox"
        return load_ggml_model(path, arch, n_ctx=n_ctx, device=self.device)

    # -- generation ----------------------------------------------------------

    def generate(
        self,
        prompt: Union[str, Sequence[int]],
        num_tokens_to_generate: int = 100,
        *,
        top_k: int = 40,
        top_p: float = 0.9,
        temperature: float = 0.9,
        repeat_penalty: float = 1.3,
        repeat_last_n: int = 64,
        seed: int = -1,
        greedy: bool = False,
        stop_tokens: Sequence[int] = (2,),  # the reference's EOS, vsim.cpp:894
        print_streaming_output: bool = False,
        streaming_token_str_hook: Optional[Callable[[str], None]] = None,
        streaming_token_ids_hook: Optional[Callable[[int], None]] = None,
    ) -> Dict[str, object]:
        """The reference's result dict: {success, token_ids, token_str},
        with generated_token_ids and timings beside them."""
        from vsim_tpu_torch.engine.sampling import SamplingParams

        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "no tokenizer available — pass token ids or a tokenizer")
            prompt_ids = self.tokenizer.encode(prompt)
        else:
            prompt_ids = [int(t) for t in prompt]

        sp = SamplingParams(
            temperature=temperature, top_k=top_k, top_p=top_p,
            repeat_penalty=repeat_penalty, repeat_last_n=repeat_last_n,
            greedy=greedy, seed=seed,
        )

        def hook(tok_id: int) -> None:
            if streaming_token_ids_hook is not None:
                streaming_token_ids_hook(tok_id)
            if streaming_token_str_hook is not None or print_streaming_output:
                s = (self.tokenizer.decode([tok_id])
                     if self.tokenizer is not None else str(tok_id))
                if streaming_token_str_hook is not None:
                    streaming_token_str_hook(s)
                if print_streaming_output:
                    print(s, end="", flush=True)

        res = self.engine.generate(
            prompt_ids, n_predict=num_tokens_to_generate, sampling=sp,
            stop_tokens=stop_tokens, streaming_token_hook=hook,
        )
        all_ids = list(res.prompt_ids) + list(res.token_ids)
        token_str = (self.tokenizer.decode(all_ids)
                     if self.tokenizer is not None else "")
        if print_streaming_output:
            print()
        return {
            "success": True,
            "token_ids": all_ids,
            "token_str": token_str,
            "generated_token_ids": list(res.token_ids),
            "timings": res.timings,
        }

    def return_logits(self, prompt_ids: Sequence[int]):
        """The reference's --return_logits mode: full-vocab logits [T, V]
        f32 numpy at every prompt position (vsim.cpp:827-873)."""
        res = self.engine.generate(
            [int(t) for t in prompt_ids], n_predict=0, return_logits=True)
        return res.logits
