"""The CLIP classifier of the port: the ViT-B/16 and text towers
(``clip``), their kernels (``vit_kernels``), the tokenizers and the
zero-shot wrapper (``clip_wrapper``)."""
