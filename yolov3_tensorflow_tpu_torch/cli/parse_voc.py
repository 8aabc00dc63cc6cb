"""Convert PASCAL-VOC XML annotations to the flat txt format (counterpart
of `yolov3_tensorflow_tpu/cli/parse_voc.py`; host only, no device).

  python -m yolov3_tensorflow_tpu_torch.cli.parse_voc --voc_root ./VOCdevkit \
      --train_sets 2007:trainval 2012:trainval --test_sets 2007:test \
      --out_dir ./data/my_data
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from yolov3_tensorflow_tpu_torch.utils.coco import VOC_CLASS_NAMES


def parse_xml(path: str, class_names: Tuple[str, ...],
              skip_difficult: bool = True) -> Optional[List[str]]:
    """One XML -> [img_path, width, height, (label xmin ymin xmax ymax)*]
    fields. Returns None if no objects remain."""
    tree = ET.parse(path)
    root = tree.getroot()
    size = root.find("size")
    width = size.find("width").text
    height = size.find("height").text

    fields: List[str] = [width, height]
    for obj in root.findall("object"):
        difficult = obj.find("difficult")
        if skip_difficult and difficult is not None and difficult.text == "1":
            continue
        name = obj.find("name").text
        if name not in class_names:
            continue
        box = obj.find("bndbox")
        fields.append(str(class_names.index(name)))
        for k in ("xmin", "ymin", "xmax", "ymax"):
            fields.append(box.find(k).text)
    if len(fields) == 2:
        return None
    return fields


def gen_split(voc_root: str, sets: List[str], out_path: str,
              class_names: Tuple[str, ...], start_index: int = 0) -> int:
    """Write one flat annotation file covering the given year:set splits."""
    idx = start_index
    with open(out_path, "w") as out:
        for spec in sets:
            year, split = spec.split(":")
            base = os.path.join(voc_root, f"VOC{year}")
            list_file = os.path.join(base, "ImageSets", "Main", f"{split}.txt")
            with open(list_file) as f:
                ids = [ln.strip() for ln in f if ln.strip()]
            for img_id in ids:
                xml_path = os.path.join(base, "Annotations", f"{img_id}.xml")
                fields = parse_xml(xml_path, class_names)
                if fields is None:
                    continue
                img_path = os.path.join(base, "JPEGImages", f"{img_id}.jpg")
                out.write(" ".join([str(idx), img_path] + fields) + "\n")
                idx += 1
    return idx


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VOC XML -> flat txt annotations")
    p.add_argument("--voc_root", type=str, required=True,
                   help="directory containing VOC2007/ VOC2012/")
    p.add_argument("--train_sets", nargs="*",
                   default=["2007:trainval", "2012:trainval"])
    p.add_argument("--test_sets", nargs="*", default=["2007:test"])
    p.add_argument("--out_dir", type=str, default=".")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    n = gen_split(args.voc_root, args.train_sets,
                  os.path.join(args.out_dir, "train.txt"), VOC_CLASS_NAMES)
    print(f"wrote {n} train lines")
    m = gen_split(args.voc_root, args.test_sets,
                  os.path.join(args.out_dir, "val.txt"), VOC_CLASS_NAMES)
    print(f"wrote {m} val lines")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
