"""Model definitions: layers, the YOLOv3 plan and forward, weight conversion."""
