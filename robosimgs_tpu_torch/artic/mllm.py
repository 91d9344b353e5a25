"""Pluggable MLLM / vision-model clients for the articulation + physics
toolchain.

A copy of robosimgs_tpu/artic/mllm.py (the port imports nothing from the
JAX package). The upstream RoboSimGS code hardwires OpenAI GPT-4V, HF
BLIP-2 and CLIP calls into its segmenters
(`Articulation/utils/gpt_utils.py`). Here every model dependency is an
interface with a recorded/scripted fake, so the pipeline runs
deterministically offline and real backends plug in where available:

  MLLMClient     — multimodal chat (image(s) + prompt -> text)
  Captioner      — image -> caption
  ImageTextScorer— zero-shot similarity of an image against text labels
  MaskGenerator  — image -> candidate binary masks (the SAM role)

Hardening carried over (and fixed): bounded retry with per-try seed bump
(the upstream retry loop had an unbound-variable crash after exhausting
retries — fixed here by raising a typed error), JSON extraction from
fenced/inline model output. The OpenAI client encodes its images with
the port's own PNG writer (cli/render.py), not Pillow; the HF clients
default to the card.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np


class MLLMError(RuntimeError):
    pass


class MLLMClient(Protocol):
    def chat(self, prompt: str, images: Sequence[np.ndarray] = (),
             seed: Optional[int] = None) -> str: ...


class Captioner(Protocol):
    def caption(self, image: np.ndarray) -> str: ...


class ImageTextScorer(Protocol):
    def score(self, image: np.ndarray, labels: Sequence[str]) -> np.ndarray:
        """Returns (len(labels),) softmax-normalized similarity scores."""


class MaskGenerator(Protocol):
    def generate(self, image: np.ndarray) -> List[np.ndarray]:
        """Returns a list of (H, W) bool candidate masks."""


# -- retry / parsing helpers ----------------------------------------------


def with_retry(fn: Callable[[int], str], tries: int = 10, sleep_s: float = 3.0,
               base_seed: int = 100, _sleep=time.sleep) -> str:
    """Call fn(seed) with a bumped seed per retry (reference semantics:
    seed=100+try, 3s backoff, 10 tries) — raising MLLMError instead of
    crashing on an unbound variable when all tries fail."""
    last: Optional[Exception] = None
    for i in range(tries):
        try:
            return fn(base_seed + i)
        except Exception as e:  # noqa: BLE001 — any backend failure retries
            last = e
            if i < tries - 1:
                _sleep(sleep_s)
    raise MLLMError(f"MLLM call failed after {tries} tries: {last}") from last


def extract_json(text: str) -> Dict:
    """Extract the first JSON object from model output (fenced or bare)."""
    fence = re.search(r"```(?:json)?\s*(\{.*?\})\s*```", text, re.DOTALL)
    if fence:
        return json.loads(fence.group(1))
    brace = re.search(r"\{.*\}", text, re.DOTALL)
    if brace:
        return json.loads(brace.group(0))
    raise ValueError(f"no JSON object in model output: {text[:200]!r}")


# -- fakes / recorded clients ---------------------------------------------


@dataclasses.dataclass
class ScriptedMLLM:
    """Deterministic fake: answers are matched by substring of the prompt
    (first match wins), with an optional default."""

    responses: List  # list of (substring, response)
    default: Optional[str] = None
    calls: List = dataclasses.field(default_factory=list)

    def chat(self, prompt: str, images: Sequence[np.ndarray] = (),
             seed: Optional[int] = None) -> str:
        self.calls.append({"prompt": prompt, "n_images": len(images), "seed": seed})
        for needle, resp in self.responses:
            if needle in prompt:
                return resp
        if self.default is not None:
            return self.default
        raise MLLMError(f"no scripted response for prompt: {prompt[:120]!r}")


@dataclasses.dataclass
class StaticCaptioner:
    text: str = "an object on a table"

    def caption(self, image: np.ndarray) -> str:
        return self.text


@dataclasses.dataclass
class UniformScorer:
    """Scores labels uniformly, or by a fixed preference table."""

    preferences: Optional[Dict[str, float]] = None

    def score(self, image: np.ndarray, labels: Sequence[str]) -> np.ndarray:
        if self.preferences:
            raw = np.asarray([self.preferences.get(l, 0.0) for l in labels],
                             np.float64)
        else:
            raw = np.zeros(len(labels))
        e = np.exp(raw - raw.max())
        return (e / e.sum()).astype(np.float32)


# -- real backends (optional, import-gated) -------------------------------


class OpenAIChat:
    """OpenAI-compatible multimodal chat client (GPT-4V-class models).

    Mirrors the reference's call shape (`gpt_utils.py:105-147`): fixed
    seed, 30 s timeout, images attached base64. Requires the `openai`
    package and OPENAI_API_KEY; unavailable in offline environments —
    use ScriptedMLLM there.
    """

    def __init__(self, model: str = "gpt-4-turbo", timeout_s: float = 30.0,
                 transport: Optional[Callable] = None):
        """transport: optional callable(model, messages, seed, timeout_s)
        -> str replacing the network call — lets tests (and alternative
        OpenAI-compatible servers) validate the exact request shape
        without the openai package or a key."""
        self.model = model
        self.timeout_s = timeout_s
        self.transport = transport
        if transport is None:
            import os

            import openai  # noqa: F401 — raises if unavailable

            self._openai = openai
            self.api_key = os.environ.get("OPENAI_API_KEY")
            if not self.api_key:
                raise MLLMError("OPENAI_API_KEY not set")

    @staticmethod
    def _b64(image: np.ndarray) -> str:
        import base64

        from robosimgs_tpu_torch.cli.render import encode_png

        rgb = np.clip(image * 255 if image.dtype != np.uint8 else image,
                      0, 255).astype(np.uint8)
        return base64.b64encode(encode_png(rgb)).decode("ascii")

    def build_messages(self, prompt: str,
                       images: Sequence[np.ndarray] = ()) -> list:
        """The exact request body the reference sends (`gpt_utils.py:
        105-125`): one user turn, text part first, then each image as a
        base64 PNG data URL."""
        content = [{"type": "text", "text": prompt}]
        for img in images:
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/png;base64,{self._b64(img)}"}})
        return [{"role": "user", "content": content}]

    def chat(self, prompt: str, images: Sequence[np.ndarray] = (),
             seed: Optional[int] = None) -> str:
        messages = self.build_messages(prompt, images)
        if self.transport is not None:
            return self.transport(self.model, messages, seed, self.timeout_s)
        client = self._openai.OpenAI(api_key=self.api_key, timeout=self.timeout_s)
        resp = client.chat.completions.create(
            model=self.model, seed=seed, messages=messages)
        return resp.choices[0].message.content


class HFCLIPScorer:
    """HuggingFace CLIP zero-shot scorer (the reference's material
    classifier, `physics_estimation.py:91-113`). Requires downloaded
    weights; offline environments use UniformScorer."""

    def __init__(self, model_name: str = "openai/clip-vit-base-patch32",
                 device: str = "cuda"):
        from transformers import CLIPModel, CLIPProcessor

        self.model = CLIPModel.from_pretrained(model_name).to(device)
        self.processor = CLIPProcessor.from_pretrained(model_name)
        self.device = device

    def score(self, image: np.ndarray, labels: Sequence[str]) -> np.ndarray:
        import torch

        inputs = self.processor(
            text=list(labels), images=image, return_tensors="pt", padding=True)
        with torch.no_grad():
            out = self.model(**{k: v.to(self.device) for k, v in inputs.items()})
        return out.logits_per_image.softmax(dim=1)[0].cpu().numpy()


class HFBlip2Captioner:
    """HuggingFace BLIP-2 captioner (the reference's object captioner,
    `gpt_utils.py:185-214`: fp16 BLIP-2 OPT-2.7B with the "a photo of"
    prefix prompt). Requires downloaded weights; offline environments
    use StaticCaptioner / a scripted fake."""

    def __init__(self, model_name: str = "Salesforce/blip2-opt-2.7b",
                 device: str = "cuda", prompt: str = "a photo of"):
        import torch
        from transformers import AutoProcessor, Blip2ForConditionalGeneration

        dtype = torch.float16 if device != "cpu" else torch.float32
        self.processor = AutoProcessor.from_pretrained(model_name)
        self.model = Blip2ForConditionalGeneration.from_pretrained(
            model_name, torch_dtype=dtype).to(device)
        self.device = device
        self.prompt = prompt

    def caption(self, image: np.ndarray) -> str:
        import torch

        img = np.clip(image * 255 if image.dtype != np.uint8 else image,
                      0, 255).astype(np.uint8)
        inputs = self.processor(images=img, text=self.prompt,
                                return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=30)
        text = self.processor.batch_decode(out, skip_special_tokens=True)[0]
        return (self.prompt + " " + text.strip()).strip()
