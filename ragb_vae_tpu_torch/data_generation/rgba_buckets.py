"""Offline RGBA bucket preparation (host-side, CPU).

Counterpart of `ragb_vae_tpu/data_generation/rgba_buckets.py`: walk the
per-sample layer directories, build alpha masks, 3x3-erode them, peel
back-to-front groups of non-overlapping foreground layers, write
LANCZOS-resized fg / composite / background / selected-component PNGs into
`{split}/{wW-hH}/` trees, and write the manifest the stage-1 loop reads
(`data/manifest.py`). A sample's randomness comes from sha256(name|seed);
the train / val split from a validation list and capacity counters (shared
`multiprocessing.Value` counters under a lock when workers run); a rerun
skips the samples already written.
"""
from __future__ import annotations

import hashlib
import json
import logging
import multiprocessing as mp
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
from PIL import Image

from ragb_vae_tpu_torch.data.buckets import BACKGROUND_VISIBILITY_THRESHOLD, bucket_assignment
from ragb_vae_tpu_torch.data.multilayer_dataset import (
    composite_layers,
    find_component_paths,
    resolve_background_path,
)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Masks and grouping
# ---------------------------------------------------------------------------
def component_alpha_mask(image: Image.Image) -> np.ndarray:
    if image.mode != "RGBA":
        image = image.convert("RGBA")
    return np.asarray(image, dtype=np.uint8)[..., 3] > 0


def build_component_masks(components: Sequence[Image.Image]) -> Dict[int, np.ndarray]:
    masks: Dict[int, np.ndarray] = {}
    for idx, image in enumerate(components):
        mask = component_alpha_mask(image)
        if np.any(mask):
            masks[idx] = mask
    return masks


def erode_masks(masks: Dict[int, np.ndarray], iterations: int) -> Dict[int, np.ndarray]:
    """3x3 binary erosion; empty erosions fall back to the raw mask."""
    if iterations <= 0:
        return {idx: mask.copy() for idx, mask in masks.items()}
    from scipy.ndimage import binary_erosion

    structure = np.ones((3, 3), dtype=bool)
    out: Dict[int, np.ndarray] = {}
    for idx, mask in masks.items():
        eroded = binary_erosion(mask, structure=structure, iterations=iterations)
        out[idx] = eroded if np.any(eroded) else mask.copy()
    return out


def background_visible_ratio(masks: Dict[int, np.ndarray]) -> float:
    """Fraction of pixels not covered by any component."""
    if not masks:
        return 1.0
    union = np.zeros_like(next(iter(masks.values())), dtype=bool)
    for mask in masks.values():
        union |= mask
    if union.size == 0:
        return 1.0
    return float(union.size - int(union.sum())) / float(union.size)


def _pairwise_overlaps(eroded_masks: Dict[int, np.ndarray]) -> Dict[int, Set[int]]:
    """idx -> set of other indices whose (eroded) masks intersect it.

    Flattens each mask once; intersection tests are dot-product-free
    `any` checks on the flat views. Computed once per sample, then every
    peel stage's grouping is pure set logic (no image-sized temporaries).
    """
    flat = {idx: mask.reshape(-1) for idx, mask in eroded_masks.items()}
    keys = sorted(flat)
    overlaps: Dict[int, Set[int]] = {idx: set() for idx in keys}
    for pos, a in enumerate(keys):
        for b in keys[pos + 1 :]:
            if np.any(flat[a] & flat[b]):
                overlaps[a].add(b)
                overlaps[b].add(a)
    return overlaps


def find_unoverlapped_indices(
    remaining: Sequence[int],
    eroded_masks: Dict[int, np.ndarray],
    *,
    overlaps: Optional[Dict[int, Set[int]]] = None,
) -> List[int]:
    """Topmost-first pick of mutually non-overlapping components.

    Output contract (pinned by dataset parity): scanning from the topmost
    layer down, a component joins the group iff it intersects none of the
    already-accepted members; the result is returned in bottom-to-top
    (ascending `remaining`) order. Implemented on a precomputed pairwise
    overlap graph rather than an accumulated coverage bitmap.

    `overlaps`: pass `_pairwise_overlaps(...)` computed ONCE per sample
    (plan_peel_schedule does) — the graph is the expensive image-sized
    part, and recomputing it per peel stage would be O(stages·k²) mask
    ANDs. The disjointness check is unaffected by graph entries outside
    `remaining` because accepted members always come from `remaining`.
    """
    if overlaps is None:
        overlaps = _pairwise_overlaps(
            {idx: eroded_masks[idx] for idx in remaining if idx in eroded_masks}
        )
        candidates = sorted(overlaps, reverse=True)
    else:
        candidates = sorted((i for i in remaining if i in overlaps), reverse=True)
    group: List[int] = []
    for idx in candidates:
        if overlaps[idx].isdisjoint(group):
            group.append(idx)
    return group[::-1]


def composite_subset(
    components: Sequence[Image.Image], indices: Sequence[int], canvas_size: Tuple[int, int]
) -> Image.Image:
    """Alpha-composite the selected layers (bottom to top) on a clear canvas."""
    from functools import reduce

    selected = (components[i].convert("RGBA") for i in indices)
    return reduce(Image.alpha_composite, selected, Image.new("RGBA", canvas_size))


def plan_peel_schedule(
    order: Sequence[int], eroded_masks: Dict[int, np.ndarray], max_groups: Optional[int]
) -> List[List[int]]:
    """Partition `order` into successive non-overlapping groups.

    Pure mask-level planning (no pixels touched): repeatedly extract the
    topmost-first non-overlapping group from what's left. Rendering is a
    separate pass — see `iterate_foreground_groups`.
    """
    overlaps = _pairwise_overlaps(
        {idx: eroded_masks[idx] for idx in order if idx in eroded_masks}
    )
    schedule: List[List[int]] = []
    left = list(order)
    while left and (max_groups is None or len(schedule) < max_groups):
        group = find_unoverlapped_indices(left, eroded_masks, overlaps=overlaps)
        if not group:
            break
        schedule.append(group)
        left = [i for i in left if i not in group]
    return schedule


def iterate_foreground_groups(
    background: Image.Image,
    components: Sequence[Image.Image],
    *,
    erosion_iterations: int,
    max_groups: Optional[int],
    masks: Optional[Dict[int, np.ndarray]] = None,
):
    """Yield (stage, picks, composite-of-remaining, fg-group) stages.

    Two phases: (1) plan the full peel schedule from eroded masks alone,
    (2) render each stage — the base image composites everything not yet
    peeled, the fg image composites just that stage's group.
    """
    masks = masks if masks is not None else build_component_masks(components)
    if not masks:
        return
    eroded = erode_masks(masks, iterations=erosion_iterations)
    # plan the FULL schedule, then emit only the first `max_groups` stages:
    # a stage's base image must still show layers that fall beyond the cap
    schedule = plan_peel_schedule(sorted(masks), eroded, None)
    emit = schedule if max_groups is None else schedule[:max_groups]
    for stage, picks in enumerate(emit):
        still_present = [i for g in schedule[stage:] for i in g]
        still_present.sort()
        base_image = composite_layers(background, [components[i] for i in still_present])
        fg_image = composite_subset(components, picks, background.size)
        yield stage, picks, base_image, fg_image


def make_sample_rng(sample_name: str, base_seed: int) -> np.random.Generator:
    digest = hashlib.sha256(f"{sample_name}|{base_seed}".encode("utf-8")).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little", signed=False))


def pick_component_by_alpha(
    indices: Sequence[int], alpha_sums: Dict[int, int], rng: np.random.Generator
) -> Optional[int]:
    """Alpha-sum-weighted random component pick."""
    if not indices:
        return None
    weights = np.array([alpha_sums.get(i, 0) for i in indices], dtype=np.float64)
    probs = weights / weights.sum() if np.any(weights) else None
    return int(rng.choice(indices, p=probs))


# ---------------------------------------------------------------------------
# Saving
# ---------------------------------------------------------------------------
def _save_resized(img: Image.Image, out_path: Path, dims: Tuple[int, int]) -> None:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    img.resize(dims, resample=Image.LANCZOS).save(out_path)


@dataclass
class PrepState:
    output_root: Path
    fg_max_groups: Optional[int] = None
    fg_erosion_iterations: int = 1
    seed: int = 42
    validation_set: Set[str] = field(default_factory=set)


def process_sample(
    sample_dir: Path,
    state: PrepState,
    claim_split: Callable[[str], Optional[str]],
) -> List[Dict[str, Any]]:
    """One sample dir -> manifest entries (and PNGs on disk)."""
    component_paths = find_component_paths(sample_dir)
    if not component_paths:
        return []

    with Image.open(resolve_background_path(sample_dir)) as bg:
        background = bg.convert("RGBA")
    components = []
    for path in component_paths:
        with Image.open(path) as img:
            components.append(img.convert("RGBA"))
    masks = build_component_masks(components)
    if not masks:
        return []
    alpha_sums = {idx: int(mask.sum()) for idx, mask in masks.items()}
    bg_visible = background_visible_ratio(masks) > BACKGROUND_VISIBILITY_THRESHOLD

    assignment, reason = bucket_assignment(background.size)
    if assignment is None:
        logger.debug("Skipping %s due to bucket exclusion: %s", sample_dir.name, reason)
        return []
    bucket_name, bucket_dims = assignment

    rng = make_sample_rng(sample_dir.name, state.seed)
    groups = list(
        iterate_foreground_groups(
            background,
            components,
            erosion_iterations=state.fg_erosion_iterations,
            max_groups=state.fg_max_groups,
            masks=masks,
        )
    )
    if not groups:
        return []

    split = claim_split(sample_dir.name)
    if split is None:
        return []

    output_root = state.output_root
    bucket_root = output_root / split / bucket_name
    # idempotent resume: first fg composite existing means already processed
    if (bucket_root / f"{sample_dir.name}_fg000_composite.png").exists():
        return []

    background_rel: Optional[str] = None
    if bg_visible:
        bg_path = bucket_root / f"{sample_dir.name}_background.png"
        _save_resized(background, bg_path, bucket_dims)
        background_rel = str(bg_path.relative_to(output_root))

    entries: List[Dict[str, Any]] = []
    composite_rel: Optional[str] = None
    composite_stage: Optional[int] = None
    last_stage = groups[-1][0]

    for stage_idx, picks, base_image, fg_image in groups:
        selected_indices: List[int] = []
        selected_paths: List[str] = []
        if stage_idx != last_stage and picks:
            first = pick_component_by_alpha(picks, alpha_sums, rng)
            if first is not None:
                sel_path = bucket_root / f"{sample_dir.name}_fg{stage_idx:03d}_selected.png"
                _save_resized(components[first], sel_path, bucket_dims)
                selected_indices.append(first)
                selected_paths.append(str(sel_path.relative_to(output_root)))
                rest = [i for i in picks if i != first]
                if rest:
                    second = pick_component_by_alpha(rest, alpha_sums, rng)
                    if second is not None:
                        sel2 = bucket_root / f"{sample_dir.name}_fg{stage_idx:03d}_selected1.png"
                        _save_resized(components[second], sel2, bucket_dims)
                        selected_indices.append(second)
                        selected_paths.append(str(sel2.relative_to(output_root)))

        comp_path = bucket_root / f"{sample_dir.name}_fg{stage_idx:03d}.png"
        _save_resized(fg_image, comp_path, bucket_dims)
        comp_rel = str(comp_path.relative_to(output_root))
        if composite_rel is None:
            compo_path = bucket_root / f"{sample_dir.name}_fg{stage_idx:03d}_composite.png"
            _save_resized(base_image, compo_path, bucket_dims)
            composite_rel = str(compo_path.relative_to(output_root))
            composite_stage = stage_idx

        entries.append(
            {
                "split": split,
                "bucket": bucket_name,
                "bucket_dims": list(bucket_dims),
                "component_path": comp_rel,
                "composite_path": composite_rel,
                "background_path": background_rel,
                "source_sample": sample_dir.name,
                "component_index": stage_idx,
                "composite_stage": composite_stage,
                "group_size": len(picks),
                "group_indices": list(picks),
                "original_size": list(fg_image.size),
                "selected_component_index": selected_indices[0] if selected_indices else None,
                "selected_component_path": selected_paths[0] if selected_paths else None,
                "selected_component_indices": selected_indices,
                "selected_component_paths": selected_paths,
            }
        )
        base_image.close()
        fg_image.close()
    logger.info("Processed %s -> %s (groups=%d)", sample_dir.name, split, len(entries))
    return entries


# ---------------------------------------------------------------------------
# Split claiming
# ---------------------------------------------------------------------------
def make_local_claimer(
    validation_set: Set[str],
    train_limit: Optional[int],
    val_limit: Optional[int],
):
    """Single-process claimer with capacity counters; returns (claim, exhausted)."""
    remaining = {"train": train_limit, "val": val_limit}

    def claim(sample_name: str) -> Optional[str]:
        split = "val" if sample_name in validation_set else "train"
        left = remaining[split]
        if left is None:
            return split
        if left > 0:
            remaining[split] = left - 1
            return split
        return None

    def exhausted() -> bool:
        return all(v is not None and v <= 0 for v in remaining.values())

    return claim, exhausted


# a worker process's state, set once by the pool's initializer
_MP_STATE: Optional[PrepState] = None
_MP_TRAIN = None
_MP_VAL = None
_MP_LOCK = None


def _init_worker(state: PrepState, train_counter, val_counter, lock) -> None:
    global _MP_STATE, _MP_TRAIN, _MP_VAL, _MP_LOCK
    _MP_STATE = state
    _MP_TRAIN = train_counter
    _MP_VAL = val_counter
    _MP_LOCK = lock


def _claim_split_mp(sample_name: str) -> Optional[str]:
    assert _MP_LOCK is not None and _MP_TRAIN is not None and _MP_VAL is not None
    with _MP_LOCK:
        counter = _MP_VAL if sample_name in _MP_STATE.validation_set else _MP_TRAIN
        split = "val" if counter is _MP_VAL else "train"
        if counter.value == -1:
            return split
        if counter.value > 0:
            counter.value -= 1
            return split
        return None


def _worker_process(sample_dir: Path) -> List[Dict[str, Any]]:
    if _MP_TRAIN is not None and _MP_TRAIN.value == 0 and _MP_VAL.value == 0:
        return []
    try:
        return process_sample(sample_dir, _MP_STATE, _claim_split_mp)
    except Exception:
        logger.exception("Failed to process %s", sample_dir)
        return []


# ---------------------------------------------------------------------------
# Post-processing
# ---------------------------------------------------------------------------
def flatten_structure(records: List[Dict[str, Any]], output_root: Path) -> None:
    """Normalize legacy nested layouts so files sit directly under the bucket
    dir and manifest paths are `{split}/{bucket}/{name}`."""
    for entry in records:
        bucket_root = output_root / entry["split"] / entry["bucket"]
        bucket_root.mkdir(parents=True, exist_ok=True)
        for key, legacy_subdir in (
            ("component_path", "components"),
            ("composite_path", "composite"),
            ("background_path", "background"),
        ):
            rel = entry.get(key)
            if not rel:
                continue
            name = Path(rel).name
            dst = bucket_root / name
            for src in (output_root / rel, bucket_root / legacy_subdir / name):
                if src.exists():
                    if src != dst:
                        src.replace(dst)
                    break
            entry[key] = str(Path(entry["split"]) / entry["bucket"] / name)
    for split_dir in (output_root / "train", output_root / "val"):
        if not split_dir.exists():
            continue
        for bucket_dir in split_dir.iterdir():
            if not bucket_dir.is_dir():
                continue
            for legacy in ("components", "composite"):
                legacy_dir = bucket_dir / legacy
                if legacy_dir.is_dir() and not any(legacy_dir.iterdir()):
                    legacy_dir.rmdir()


def write_manifest(records: List[Dict[str, Any]], manifest_path: Path) -> None:
    manifest_path.parent.mkdir(parents=True, exist_ok=True)
    manifest_path.write_text(json.dumps(records, ensure_ascii=False, indent=2))


def load_validation_set(path: Optional[Path]) -> Set[str]:
    if path is None or not Path(path).exists():
        return set()
    return {line.strip() for line in Path(path).read_text().splitlines() if line.strip()}


# ---------------------------------------------------------------------------
# Top-level run
# ---------------------------------------------------------------------------
def run_prepare(
    rendered_root: Path,
    output_root: Path,
    *,
    validation_list: Optional[Path] = None,
    train_count: Optional[int] = None,
    val_count: Optional[int] = None,
    fg_max_groups: Optional[int] = None,
    fg_erosion_iterations: int = 1,
    num_workers: int = 1,
    seed: int = 42,
    max_samples: Optional[int] = None,
) -> List[Dict[str, Any]]:
    validation_set = load_validation_set(validation_list)
    sample_dirs = sorted(d for d in Path(rendered_root).iterdir() if d.is_dir())
    if max_samples is not None:
        sample_dirs = sample_dirs[:max_samples]
    rng = np.random.default_rng(seed)
    indices = np.arange(len(sample_dirs))
    rng.shuffle(indices)
    shuffled = [sample_dirs[i] for i in indices]

    output_root = Path(output_root)
    output_root.mkdir(parents=True, exist_ok=True)
    state = PrepState(
        output_root=output_root,
        fg_max_groups=fg_max_groups,
        fg_erosion_iterations=fg_erosion_iterations,
        seed=seed,
        validation_set=validation_set,
    )

    records: List[Dict[str, Any]] = []
    if num_workers <= 1:
        claim, exhausted = make_local_claimer(validation_set, train_count, val_count)
        for sample_dir in shuffled:
            if exhausted():
                break
            records.extend(process_sample(sample_dir, state, claim))
    else:
        # spawned workers: the caller's process may hold threads, which fork does not copy
        ctx = mp.get_context("spawn")
        train_counter = ctx.Value("i", -1 if train_count is None else train_count)
        val_counter = ctx.Value("i", -1 if val_count is None else val_count)
        lock = ctx.Lock()
        with ctx.Pool(
            processes=num_workers,
            initializer=_init_worker,
            initargs=(state, train_counter, val_counter, lock),
        ) as pool:
            for entries in pool.imap_unordered(_worker_process, shuffled):
                records.extend(entries)
                if train_counter.value == 0 and val_counter.value == 0:
                    pool.terminate()
                    break

    flatten_structure(records, output_root)
    write_manifest(records, output_root / "metadata" / "manifest.json")
    logger.info("Manifest written with %d entries.", len(records))
    return records
