"""Evaluation: VOC-style mAP and quick batch recall/precision metrics."""
