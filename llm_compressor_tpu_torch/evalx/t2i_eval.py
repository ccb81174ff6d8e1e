"""Text-to-image compression evaluator (port of ``evalx/t2i_eval.py``).

The reference ships a forward-looking T2I evaluator for diffusion-model
compression (reference evaluation/t2i_eval.py:24-299: category prompt
sets, origin-vs-compressed image generation, FID / LPIPS / ImageReward /
CLIPScore) with no in-tree diffusion adapter. This mirrors the interface
and the prompt handling. Metric back ends:

* CLIPScore and ImageReward run on the port's own towers (``clip.py``,
  ``image_reward.py``); they need only a local checkpoint (no hub
  download).
* FID and LPIPS delegate to cleanfid and lpips, as the reference does
  (feature-extractor metrics over pretrained Inception / AlexNet; optional,
  import-gated).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

LOGGER = logging.getLogger(__name__)

PROMPT_SETS: Dict[str, List[str]] = {
    "animals": [
        "a photo of a red fox in a snowy forest",
        "a close-up of a parrot with rainbow feathers",
        "an elephant walking through tall savanna grass",
    ],
    "scenes": [
        "a mountain lake at sunrise, mist over the water",
        "a narrow cobblestone street in an old European town",
        "a neon-lit city street at night in the rain",
    ],
    "objects": [
        "a ceramic teapot with blue floral patterns",
        "a vintage typewriter on a wooden desk",
        "a bowl of fresh strawberries on a marble counter",
    ],
}


class T2IEvaluator:
    """Evaluate a compressed text-to-image model against its original.

    ``generate_image(prompt, seed) -> np.ndarray (H, W, 3) uint8`` callables
    supply the two models (mirrors the reference's ``model.generate_image``
    hook). Metrics run on the saved image directories.
    """

    def __init__(self, origin_generate: Callable, compressed_generate: Callable,
                 out_dir: str = "./t2i_eval", n_images_per_prompt: int = 2,
                 seed: int = 0, clip_path: Optional[str] = None,
                 image_reward_path: Optional[str] = None,
                 bert_tokenizer_path: Optional[str] = None):
        self.origin_generate = origin_generate
        self.compressed_generate = compressed_generate
        self.out_dir = Path(out_dir)
        self.n = n_images_per_prompt
        self.seed = seed
        self.clip_path = clip_path
        self.image_reward_path = image_reward_path
        self.bert_tokenizer_path = bert_tokenizer_path
        self.prompts: Dict[str, str] = {}  # image filename -> prompt

    def _generate_set(self, generate: Callable, subdir: str,
                      categories: Optional[List[str]] = None) -> Path:
        from PIL import Image

        d = self.out_dir / subdir
        d.mkdir(parents=True, exist_ok=True)
        cats = categories or list(PROMPT_SETS)
        i = 0
        for cat in cats:
            for prompt in PROMPT_SETS[cat]:
                for r in range(self.n):
                    img = generate(prompt, seed=self.seed + r)
                    name = f"{cat}_{i:04d}.png"
                    Image.fromarray(np.asarray(img, np.uint8)).save(d / name)
                    self.prompts[name] = prompt
                    i += 1
        return d

    def _pairs(self, d_org: Path, d_cmp: Path):
        """Aligned (origin_image, compressed_image, prompt) arrays."""
        from PIL import Image

        org, cmp_, prompts = [], [], []
        for a, b in zip(sorted(d_org.glob("*.png")), sorted(d_cmp.glob("*.png"))):
            org.append(np.asarray(Image.open(a), np.uint8))
            cmp_.append(np.asarray(Image.open(b), np.uint8))
            prompts.append(self.prompts.get(a.name, a.stem))
        return org, cmp_, prompts

    def eval(self, metrics: str = "fid,lpips", categories=None) -> Dict[str, float]:
        d_org = self._generate_set(self.origin_generate, "origin", categories)
        d_cmp = self._generate_set(self.compressed_generate, "compressed", categories)
        results: Dict[str, float] = {}
        for metric in [m.strip() for m in metrics.split(",") if m.strip()]:
            try:
                results[metric] = getattr(self, f"_eval_{metric}")(d_org, d_cmp)
                LOGGER.info(f"T2I[{metric.upper()}] : {results[metric]:.4f}")
            except ImportError as e:
                LOGGER.warning(f"T2I metric {metric!r} unavailable: {e}")
                results[metric] = float("nan")
        return results

    def _eval_fid(self, d_org: Path, d_cmp: Path) -> float:
        from cleanfid import fid

        return float(fid.compute_fid(str(d_org), str(d_cmp)))

    def _eval_lpips(self, d_org: Path, d_cmp: Path) -> float:
        import lpips
        import torch
        from PIL import Image

        loss = lpips.LPIPS(net="alex")
        vals = []
        for a, b in zip(sorted(d_org.glob("*.png")), sorted(d_cmp.glob("*.png"))):
            ta = torch.from_numpy(np.asarray(Image.open(a), np.float32) / 127.5 - 1).permute(2, 0, 1)[None]
            tb = torch.from_numpy(np.asarray(Image.open(b), np.float32) / 127.5 - 1).permute(2, 0, 1)[None]
            with torch.no_grad():
                vals.append(float(loss(ta, tb)))
        return float(np.mean(vals))

    def _eval_clipscore(self, d_org: Path, d_cmp: Path) -> float:
        """CLIPScore on the port's CLIP (``clip.py``): the compressed set's
        mean (the reference logs origin and compressed; both are logged and
        the compressed one, the quantity under evaluation, returned)."""
        if self.clip_path is None:
            raise ImportError("clip_path not set (local CLIP checkpoint dir)")
        from .clip import ClipScorer

        scorer = ClipScorer(self.clip_path)
        org, cmp_, prompts = self._pairs(d_org, d_cmp)
        s_org = float(np.mean(scorer.score(org, prompts)))
        s_cmp = float(np.mean(scorer.score(cmp_, prompts)))
        LOGGER.info(f"T2I[CLIPScore] origin={s_org:.4f} compressed={s_cmp:.4f}")
        return s_cmp

    def _eval_imagereward(self, d_org: Path, d_cmp: Path) -> float:
        """ImageReward on the port's BLIP towers (``image_reward.py``); the
        compressed set's mean."""
        if self.image_reward_path is None or self.bert_tokenizer_path is None:
            raise ImportError(
                "image_reward_path / bert_tokenizer_path not set "
                "(local ImageReward-v1.0 .pt + BERT tokenizer dir)")
        from .image_reward import ImageRewardScorer

        scorer = ImageRewardScorer(self.image_reward_path,
                                   self.bert_tokenizer_path)
        org, cmp_, prompts = self._pairs(d_org, d_cmp)
        s_org = float(np.mean(scorer.score(org, prompts)))
        s_cmp = float(np.mean(scorer.score(cmp_, prompts)))
        LOGGER.info(f"T2I[ImageReward] origin={s_org:.4f} compressed={s_cmp:.4f}")
        return s_cmp
