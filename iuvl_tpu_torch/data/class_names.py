"""Dataset class-name catalogs, the port's own copy of the COCO part of
``iuvl_tpu/data/class_names.py``: per-dataset class lists with a trailing
"background" entry, the no-object text embedding. COCO panoptic's 133
classes (80 things, then 53 stuff) are the public label set.
"""

from __future__ import annotations

COCO_PANOPTIC_THINGS = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

COCO_PANOPTIC_STUFF = [
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house",
    "light", "mirror-stuff", "net", "pillow", "platform", "playingfield",
    "railroad", "river", "road", "roof", "sand", "sea", "shelf", "snow",
    "stairs", "tent", "towel", "wall-brick", "wall-stone", "wall-tile",
    "wall-wood", "water-other", "window-blind", "window-other",
    "tree-merged", "fence-merged", "ceiling-merged", "sky-other-merged",
    "cabinet-merged", "table-merged", "floor-other-merged",
    "pavement-merged", "mountain-merged", "grass-merged", "dirt-merged",
    "paper-merged", "food-other-merged", "building-other-merged",
    "rock-merged", "wall-other-merged", "rug-merged",
]

COCO_PANOPTIC_CLASSES = COCO_PANOPTIC_THINGS + COCO_PANOPTIC_STUFF  # 133
COCO_THING_IDS = set(range(len(COCO_PANOPTIC_THINGS)))  # contiguous 0..79


def get_class_names(dataset_name: str | None, num_classes: int = 10) -> list[str] | None:
    """Class names plus the trailing background, keyed by a substring of
    the dataset's name as in the JAX package; the port has ``synthetic``
    and ``coco`` (the other catalogs are not ported and raise)."""
    if dataset_name is None:
        return None
    n = dataset_name.lower()
    if "synthetic" in n:
        return [f"object {i}" for i in range(num_classes)] + ["background"]
    # Names that JAX's get_class_names matches before "coco" (RefCOCO, the
    # VLP / instruction / VQA sets, COCO-Stuff) take other catalogs.
    earlier = ("refcoco", "vlp", "instruction", "instp", "vqa", "stuff_10k", "stuff10k")
    if "coco" in n and not any(e in n for e in earlier):
        return COCO_PANOPTIC_CLASSES + ["background"]
    raise NotImplementedError(
        f"class names for {dataset_name!r} are not ported yet: the port has 'synthetic' "
        "and 'coco' (ROADMAP.md A4)")
