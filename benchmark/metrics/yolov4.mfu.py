"""yolov4.mfu: the YOLOv4 packed forward's model FLOPs over the traced part
of the window against the card's bf16 peak: the images whose detections
reached the host there, times one image's forward (the frozen
`costs_yolov4.walk` at the cell's size and classes), over the traced
window's device time."""

from benchmark import costs, costs_yolov4

UNIT = "%"
LAYER = "packed forward"
MOVES = "serve_img_per_s"
READS = ("the traced window (device time between the markers)",
         "images whose detections reached the host in it")


def read(view, ctx):
    c = ctx.config
    flops = costs_yolov4.forward_flops(c["height"], c["width"],
                                       c["num_classes"])
    return (100.0 * flops * view["images"] / view["tracer"].window_s
            / costs.H100_PEAKS["bf16"])
