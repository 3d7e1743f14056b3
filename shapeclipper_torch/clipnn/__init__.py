"""CLIP nearest-neighbour annotation (counterpart of
`shapeclipper_tpu/clipnn/`)."""
