"""The benchmark's plain reference: YOLOv3 in plain PyTorch, float32.

Written from the published description (YOLOv3, arXiv:1804.02767, and
darknet's `cfg/yolov3.cfg`) and the VOC recipe's loss, with no kernel,
cache or batching trick. It imports neither JAX nor the package under test,
and takes nothing the program made: it reads the weights and inputs the
benchmark drew, and the program's outputs only to judge them.
"""
