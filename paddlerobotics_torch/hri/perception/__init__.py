"""Scene perception for the HRI service: YOLOv4, NMS, RoIAlign and the
visual tokens."""
