"""The benchmark of the PyTorch and CUDA port (`mlsp_tpu_torch`); see
README.md."""
