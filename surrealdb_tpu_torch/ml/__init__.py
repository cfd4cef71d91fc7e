"""Model inference of the port: ONNX graphs executed with torch library
ops on the card (`onnx.py`, the reference's `ml/onnx.py`)."""
