"""Image-caption dataset and batching (port of ``mit_tpu/data/dataset.py``).

The JAX package's module cannot be reused as it is: its preprocessor import
pulls in JAX. Behaviours kept:

- one example per (image, caption) pair; missing image files and
  non-string captions are skipped with a warning;
- a corrupt image at read time gives a black image and an all-PAD caption
  instead of raising;
- a truncated caption is forced to end with END;
- teacher forcing: input ``caps[:, :-1]``, target ``caps[:, 1:]``, so
  T = MAX_SEQ_LEN − 1; the last partial batch is padded with all-PAD rows
  (zero loss under the PAD-masked cross entropy), so every step has one
  shape;
- ``num_workers`` threads load and preprocess ahead of the consumer.

Images are decoded with PIL (imported at first use) through the port's
:class:`HostPreprocessor`; the JAX package's C++ JPEG loader is not ported.
:func:`prefetch_to_device` copies batches to an explicit device, from
pinned host memory with ``non_blocking=True`` on a CUDA device, one batch
ahead of the consumer.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mit_tpu_torch.data.preprocess import HostPreprocessor

DUMMY_PATH = "error_loading_image_path"


class ImageTextDataset:
    """Flattened (image, caption) pairs with lazy per-item preprocessing.

    ``tokenizer`` needs ``encode``, ``pad_id`` and ``end_id`` (the JAX
    package's and the port's ``text.Tokenizer``)."""

    def __init__(self, image_dir: str, captions_file: str, max_seq_len: int,
                 tokenizer, encoder_name: str, verbose: bool = True,
                 image_size: Optional[int] = None):
        self.image_dir = image_dir
        self.max_seq_len = max_seq_len
        self.tokenizer = tokenizer
        self.preprocessor = HostPreprocessor(encoder_name, image_size)
        self.image_paths: List[str] = []
        self.captions: List[str] = []

        try:
            with open(captions_file, "r", encoding="utf-8") as f:
                captions_data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError) as e:
            if verbose:
                print(f"Error: cannot read captions from {captions_file} ({e}). "
                      "Dataset will be empty.")
            return
        if not isinstance(captions_data, dict):
            if verbose:
                print(f"Error: Captions data from {captions_file} is not a dict.")
            return

        for filename, caption_list in captions_data.items():
            img_path = os.path.join(image_dir, filename)
            if not os.path.exists(img_path):
                if verbose:
                    print(f"Warning: image listed in captions but not found: "
                          f"{img_path}. Skipping.")
                continue
            if isinstance(caption_list, str):
                caption_list = [caption_list]
            for caption in caption_list:
                if isinstance(caption, str):
                    self.image_paths.append(img_path)
                    self.captions.append(caption)
                elif verbose:
                    print(f"Warning: non-string caption for {filename}: "
                          f"{caption!r}. Skipping.")
        if verbose:
            print(f"Loaded {len(self.image_paths)} image-caption pairs.")

    def __len__(self) -> int:
        return len(self.image_paths)

    def encode_caption(self, caption: str) -> np.ndarray:
        """Token ids (MAX_SEQ_LEN,), padded or cut, ending in END or PAD."""
        ids = np.asarray(self.tokenizer.encode(caption)[: self.max_seq_len],
                         dtype=np.int32)
        if ids[-1] != self.tokenizer.pad_id and ids[-1] != self.tokenizer.end_id:
            ids[-1] = self.tokenizer.end_id
        return ids

    def _dummy_caption(self) -> np.ndarray:
        return np.full((self.max_seq_len,), self.tokenizer.pad_id, np.int32)

    def text_item(self, idx: int, bad_paths=None) -> Dict:
        """An item without pixels, for training from cached features;
        ``bad_paths`` (failed at cache build) give the dummy item."""
        img_path = self.image_paths[idx]
        if bad_paths and img_path in bad_paths:
            return {"image_path": DUMMY_PATH, "caption_tokens": self._dummy_caption()}
        return {"image_path": img_path,
                "caption_tokens": self.encode_caption(self.captions[idx])}

    def load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return self.preprocessor(im)

    def __getitem__(self, idx: int) -> Dict:
        img_path = self.image_paths[idx]
        try:
            image = self.load_image(img_path)
        except Exception as e:  # a corrupt image → the dummy item, never raise
            print(f"Error loading image {img_path}: {e}. Returning a dummy item.")
            th, tw = self.preprocessor.spec.target
            return {"image_path": DUMMY_PATH,
                    "image": np.zeros((3, th, tw), np.float32),
                    "caption_tokens": self._dummy_caption()}
        return {"image_path": img_path, "image": image,
                "caption_tokens": self.encode_caption(self.captions[idx])}


# ----------------------------------------------------------------------
def split_indices(n: int, train_ratio: float, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic train/val split (the JAX package's permutation)."""
    perm = np.random.default_rng(seed).permutation(n)
    k = int(train_ratio * n)
    return perm[:k], perm[k:]


def collate(items: Sequence[Dict], pad_id: int, batch_size: int) -> Dict:
    """Stack items, shift for teacher forcing and pad to ``batch_size``:
    ``decoder_input_tokens`` and ``target_tokens`` (B, MAX_SEQ_LEN − 1),
    ``valid`` (B,), ``images`` (B, 3, H, W) when the items carry pixels."""
    n = len(items)
    caps = np.stack([it["caption_tokens"] for it in items])
    if n < batch_size:
        caps = np.concatenate(
            [caps, np.full((batch_size - n, caps.shape[1]), pad_id, caps.dtype)])
    out = {
        "image_paths": [it["image_path"] for it in items],
        "decoder_input_tokens": caps[:, :-1],
        "target_tokens": caps[:, 1:],
        "valid": np.arange(batch_size) < n,
    }
    if "image" in items[0]:
        images = np.stack([it["image"] for it in items])
        if n < batch_size:
            images = np.concatenate(
                [images, np.zeros((batch_size - n, *images.shape[1:]),
                                  images.dtype)])
        out["images"] = images
    return out


def to_device(arrays: dict, device) -> Dict[str, torch.Tensor]:
    """Batch arrays (numpy or host tensors) → tensors on ``device``, token
    ids as int64; on a CUDA device the copy starts from pinned memory and
    does not block."""
    device = torch.device(device)
    out = {}
    for k, a in arrays.items():
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def prefetch_to_device(iterator, transform, depth: int = 2):
    """Yield ``transform(item)`` with ``depth`` − 1 items transformed ahead:
    the next batch's host work and copy are issued before the consumer
    runs the current step."""
    buf = collections.deque()
    for item in iterator:
        buf.append(transform(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class Loader:
    """Prefetching batch iterator over a subset of a dataset:
    ``num_workers`` threads keep ``prefetch`` batches ready.

    ``load_images=False`` skips pixel work (batches carry tokens and paths
    only), for training from cached encoder features; ``bad_paths`` keep
    the dummy-item semantics of images that failed at cache build.
    """

    def __init__(self, dataset: ImageTextDataset, indices, batch_size: int,
                 shuffle: bool, seed: int = 0, num_workers: int = 2,
                 prefetch: int = 4, load_images: bool = True,
                 bad_paths=None):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.load_images = load_images
        self.bad_paths = bad_paths
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[np.ndarray]:
        order = self.indices
        if self.shuffle:
            order = order[np.random.default_rng(self.seed + self._epoch)
                          .permutation(len(order))]
        for i in range(0, len(order), self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self) -> Iterator[Dict]:
        self._epoch += 1
        pad_id = self.dataset.tokenizer.pad_id
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        if self.load_images:
            fetch = self.dataset.__getitem__
        else:
            fetch = lambda i: self.dataset.text_item(i, self.bad_paths)

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for chunk in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(fetch, chunk))
                        q.put(collate(items, pad_id, self.batch_size))
                finally:
                    q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            while not q.empty():        # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
