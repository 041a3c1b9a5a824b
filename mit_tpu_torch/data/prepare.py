"""Flickr30k dataset provisioning: download, assemble, extract, convert.

Re-implementation of the reference's auto-prepare flow (reference
prepare_dataset.py:29-582) with the same steps and idempotency semantics:

  1. idempotency gate: skip everything if images + captions.json exist
     (reference :124-167, :331-333);
  2. stream-download the 3 GitHub release parts (reference :60-64, :69-122);
  3. byte-concatenate the parts into a single zip (reference :374-398);
  4. extract (reference :400-432);
  5. locate images in candidate subdirs and move them into IMAGE_DIR
     (reference :434-519);
  6. find results.csv / captions.txt and convert CSV → captions.json with
     delimiter sniffing ('|' vs ',') and header detection with positional
     fallback (reference :191-308, :521-550);
  7. clean up the temp download dir and sanity-check (reference :552-573).
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import zipfile
from typing import Dict, List, Optional

from mit_tpu_torch.config import CONFIG, Config

FLICKR30K_URLS = [
    "https://github.com/awsaf49/flickr-dataset/releases/download/v1.0/flickr30k_part00",
    "https://github.com/awsaf49/flickr-dataset/releases/download/v1.0/flickr30k_part01",
    "https://github.com/awsaf49/flickr-dataset/releases/download/v1.0/flickr30k_part02",
]

# Subdirectories the extracted archive is known to place images in
# (reference prepare_dataset.py:434-519 probes these plus the root).
IMAGE_SUBDIR_CANDIDATES = ["Images", "flickr30k-images", "flickr30k_images", ""]
IMAGE_EXTS = (".jpg", ".jpeg", ".png")
CAPTION_FILE_CANDIDATES = ["results.csv", "captions.txt"]


def download_file(url: str, dest_path: str, chunk_size: int = 1 << 20) -> bool:
    """Stream a URL to disk with a progress line (reference :69-122)."""
    import requests

    try:
        with requests.get(url, stream=True, timeout=60) as r:
            r.raise_for_status()
            total = int(r.headers.get("content-length", 0))
            done = 0
            os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
            with open(dest_path, "wb") as f:
                for chunk in r.iter_content(chunk_size=chunk_size):
                    f.write(chunk)
                    done += len(chunk)
                    if total:
                        print(
                            f"\r  {os.path.basename(dest_path)}: "
                            f"{done / 1e6:.0f}/{total / 1e6:.0f} MB",
                            end="",
                        )
            print()
        return True
    except Exception as e:
        print(f"Error downloading {url}: {e}")
        if os.path.exists(dest_path):
            os.remove(dest_path)
        return False


def check_dataset_exists(cfg: Config = CONFIG) -> bool:
    """Images dir non-empty + captions JSON present (reference :124-167)."""
    img_dir = cfg.IMAGE_DIR
    if not os.path.isdir(img_dir):
        return False
    has_images = any(
        name.lower().endswith(IMAGE_EXTS) for name in os.listdir(img_dir)
    )
    return has_images and os.path.exists(cfg.CAPTIONS_FILE)


def concatenate_parts(part_paths: List[str], out_zip: str) -> None:
    """Byte-concatenate split archive parts into one zip (reference :374-398)."""
    with open(out_zip, "wb") as out:
        for p in part_paths:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out)


# ----------------------------------------------------------------------
def _sniff_delimiter(csv_path: str) -> str:
    """'|' if the first line has ≥2 pipes, else ',' (reference :191-204)."""
    try:
        with open(csv_path, "r", encoding="utf-8") as f:
            first = f.readline()
        if first.count("|") >= 2:
            return "|"
    except Exception as e:
        print(f"Warning: could not sniff delimiter of {csv_path}: {e}")
    return ","


def convert_csv_to_json(csv_path: str, json_path: str) -> bool:
    """CSV/pipe captions file → ``{image: [captions]}`` JSON.

    Header detection looks for image/caption-like column names; without a
    header, positional fallback is image=col 0, caption=col 2 for '|' files
    (image|index|caption) or col 1 for ',' files (reference :216-264).
    """
    if not os.path.exists(csv_path):
        print(f"Error: captions source not found: {csv_path}")
        return False

    delim = _sniff_delimiter(csv_path)
    captions: Dict[str, List[str]] = {}

    with open(csv_path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=delim, quotechar='"')
        image_col, caption_col = 0, (2 if delim == "|" else 1)
        rows = iter(reader)
        try:
            first = next(rows)
        except StopIteration:
            print("Warning: captions CSV is empty.")
            return False
        cols = [c.strip().lower() for c in first]
        img_idx = cap_idx = None
        # last matching column wins (reference :246-256 loops over all
        # columns, overwriting — "comment" beats "comment_number")
        for i, c in enumerate(cols):
            if "image" in c:
                img_idx = i
            if "caption" in c or "comment" in c:
                cap_idx = i
        if img_idx is not None and cap_idx is not None:
            image_col, caption_col = img_idx, cap_idx
        else:
            # first row was data, not a header — process it too
            rows = iter([first] + list(rows))

        for row in rows:
            if len(row) <= max(image_col, caption_col):
                print(f"Warning: skipping malformed CSV row: {row}")
                continue
            image_name = row[image_col].strip()
            caption = row[caption_col].strip().strip('"').strip()
            if not image_name:
                continue
            captions.setdefault(image_name, []).append(caption)

    if not captions:
        print(f"Error: no captions extracted from {csv_path}.")
        return False

    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(captions, f, indent=2)
    print(f"Converted captions for {len(captions)} images -> {json_path}")
    return True


# ----------------------------------------------------------------------
def _locate_and_move_images(extract_dir: str, image_dir: str) -> int:
    """Find images under candidate subdirs (recursively) and move them
    into ``image_dir`` (reference :434-519)."""
    os.makedirs(image_dir, exist_ok=True)
    moved = 0
    for sub in IMAGE_SUBDIR_CANDIDATES:
        root = os.path.join(extract_dir, sub) if sub else extract_dir
        if not os.path.isdir(root):
            continue
        for dirpath, _, filenames in os.walk(root):
            for name in filenames:
                if name.lower().endswith(IMAGE_EXTS):
                    src = os.path.join(dirpath, name)
                    dst = os.path.join(image_dir, name)
                    if os.path.abspath(src) != os.path.abspath(dst):
                        shutil.move(src, dst)
                    moved += 1
        if moved:
            break
    return moved


def _find_captions_source(extract_dir: str) -> Optional[str]:
    for dirpath, _, filenames in os.walk(extract_dir):
        for cand in CAPTION_FILE_CANDIDATES:
            if cand in filenames:
                return os.path.join(dirpath, cand)
    return None


def prepare_flickr30k(cfg: Config = CONFIG, urls: Optional[List[str]] = None) -> bool:
    """Full provisioning pipeline; idempotent (reference :324-582)."""
    if check_dataset_exists(cfg):
        print("Dataset already prepared — skipping download.")
        return True

    urls = urls or FLICKR30K_URLS
    tmp_dir = os.path.join(cfg.DATA_DIR, "temp_download")
    os.makedirs(tmp_dir, exist_ok=True)
    try:
        # 1. download parts
        parts = []
        for url in urls:
            dest = os.path.join(tmp_dir, os.path.basename(url))
            if not os.path.exists(dest):
                print(f"Downloading {url} ...")
                if not download_file(url, dest):
                    print("Download failed — aborting dataset preparation.")
                    return False
            parts.append(dest)

        # 2. byte-concatenate into one zip
        zip_path = os.path.join(tmp_dir, "flickr30k.zip")
        print("Assembling archive parts ...")
        concatenate_parts(parts, zip_path)

        # 3. extract
        extract_dir = os.path.join(tmp_dir, "extracted")
        os.makedirs(extract_dir, exist_ok=True)
        print("Extracting ...")
        with zipfile.ZipFile(zip_path, "r") as zf:
            zf.extractall(extract_dir)

        # 4. move images into place
        moved = _locate_and_move_images(extract_dir, cfg.IMAGE_DIR)
        print(f"Moved {moved} images into {cfg.IMAGE_DIR}")

        # 5. captions CSV → JSON
        src = _find_captions_source(extract_dir)
        if src is None:
            print("Error: no captions CSV found in the archive.")
            return False
        if not convert_csv_to_json(src, cfg.CAPTIONS_FILE):
            return False
    finally:
        # 6. cleanup temp
        shutil.rmtree(tmp_dir, ignore_errors=True)

    ok = check_dataset_exists(cfg)
    if not ok:
        print("Warning: dataset preparation finished but sanity check failed.")
    return ok
