"""mxnet_tpu_torch.transformer — the TransformerLM of ``mxnet_tpu``, for
decode serving and for training through the mesh tier.

The widest configuration the reference documents serves as::

    cfg = TransformerLMConfig(vocab_size=256, d_model=128, n_heads=8,
                              n_layers=4, d_ff=512, seq_len=1024)
    prog = DecodeProgram(cfg, page_size=8)
    params = from_jax_params(prog.program.init_params(0))   # on CUDA

and trains, with ring attention over a ``sequence`` axis of 2, as::

    trainer = DataParallelTrainer(TransformerLM(cfg), None, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9},
                                  mesh_plan=MeshPlan(sequence=2))
    loss = trainer.step(tokens, labels)     # (B, 1024) integer arrays
"""
from .model import (TransformerLMConfig, TransformerLM, MeshProgram,
                    from_jax_params)
from .decode import DecodeProgram
from .step import build_parts

__all__ = ["TransformerLMConfig", "TransformerLM", "MeshProgram",
           "from_jax_params", "DecodeProgram", "build_parts"]
