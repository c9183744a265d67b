"""incagg_gnn_tpu_torch — the PyTorch / CUDA port of ``incagg_gnn_tpu``.

Scalable GNN training with historical embeddings (GAS) and incremental,
variance-reduced aggregation (Reverb/VR), on one NVIDIA Hopper GPU.  The
JAX package beside it is the reference this port is held against; this
package imports torch and numpy and never JAX.  Entry point:
``python -m incagg_gnn_tpu_torch``.
"""
