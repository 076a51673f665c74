"""GQA flash-decode: the CUDA kernel ``csrc/decode_attn.cu`` behind
:func:`.decode_attn.decode_attn`, its plain version :mod:`.ref`, and the
model-layout wrappers :mod:`.ops`."""
