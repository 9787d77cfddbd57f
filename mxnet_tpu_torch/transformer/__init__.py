"""mxnet_tpu_torch.transformer — the TransformerLM of ``mxnet_tpu``,
for decode serving.

The widest configuration the reference documents serves as::

    cfg = TransformerLMConfig(vocab_size=256, d_model=128, n_heads=8,
                              n_layers=4, d_ff=512, seq_len=1024)
    prog = DecodeProgram(cfg, page_size=8)
    params = from_jax_params(prog.program.init_params(0))   # on CUDA
"""
from .model import TransformerLMConfig, MeshProgram, from_jax_params
from .decode import DecodeProgram

__all__ = ["TransformerLMConfig", "MeshProgram", "from_jax_params",
           "DecodeProgram"]
