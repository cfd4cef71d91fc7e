"""Kernel wrappers and their plain PyTorch versions.

distance: [B, N] distance matrices (csrc/distance.cu)
topk:     exact top-k selection, exact and blocked KNN, bf16 rank + f32
          rescore, the int8 ranking store and its quantisation
          (csrc/select.cu, csrc/rank_rescore.cu, csrc/rank_int8.cu)
metrics:  metric ids
"""
