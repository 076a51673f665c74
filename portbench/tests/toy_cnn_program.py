"""The program side of the toy architecture (``toy_cnn``): the port's
``ReinterpretedModel`` built from op dicts by the port's own
``trace_sequential``, carrying the benchmark's weights.

Copied into a benchmark's ``portbench/programs/toy_cnn.py`` by the CPU
tests."""
from __future__ import annotations


def program_model(model_cfg: dict, weights: dict, published: list):
    """The program's model of ``model_cfg``; raises where a layer's name,
    kind or shapes differ from ``published``, the reference's layers."""
    from repro_torch.core.reinterpret import trace_sequential
    width, pw = model_cfg["width"], model_cfg["pointwise"]
    ops = [
        dict(kind="conv", name="conv0", out_channels=width, kernel=(3, 3),
             stride=(2, 2), padding=(1, 1), activation="relu6"),
        dict(kind="dwconv", name="dw1", kernel=(3, 3), stride=(1, 1),
             padding=(1, 1), activation="relu6"),
        dict(kind="conv", name="pw2", out_channels=pw, kernel=(1, 1),
             stride=(1, 1), padding=(0, 0), activation="relu6"),
        dict(kind="avgpool", name="pool"),
        dict(kind="linear", name="fc", features=model_cfg["num_classes"]),
    ]
    for op in ops:
        if op["name"] in weights:
            op["weight"], op["bias"] = weights[op["name"]]
    model = trace_sequential(ops, tuple(model_cfg["input"]))
    got = [(s.name, s.kind, s.in_shape[0], s.out_shape[0]) for s in
           model.layers]
    want = [(lyr.name, lyr.kind, lyr.cin, lyr.cout) for lyr in published]
    if got != want:
        raise RuntimeError(f"the program's toy_cnn differs from the "
                           f"published one: {got} != {want}")
    return model
