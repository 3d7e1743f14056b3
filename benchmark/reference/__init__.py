"""The benchmark's plain reference: ShapeClipper's mathematics in plain
PyTorch (`model.py`), a training step and a request built from it
(`step.py`), and a mesh extractor (`mesh.py`). It imports nothing of the
program under test."""
