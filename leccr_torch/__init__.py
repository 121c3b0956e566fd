"""leccr_torch: the PyTorch + CUDA port of leccr_tpu for NVIDIA Hopper.

Inference slice: the LECCR image model (CLIP ViT + mBERT + caption
interaction), the streaming Recall@K ranker and the single-device serving
index.  Imports nothing from JAX or `leccr_tpu`.
"""
