"""The benchmark's plain reference: plain PyTorch and NumPy, importing
nothing of the program under test.  One file an architecture,
``<arch>.py``, found by a configuration's ``model.arch``: it provides
``layers(model)`` (each layer's ``name``, ``kind``, ``cin``, ``cout``,
``weight_shape``, ``fan_in``, ``macs``, ``elems_read`` and
``elems_written``) and ``Reference(model, weights, calibration, device,
weight_bits=8)``, which answers images with int16 codes."""
