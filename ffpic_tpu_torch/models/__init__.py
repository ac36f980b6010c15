"""Models behind the batched decode: the ViT of BASELINE config 5
(``models.vit``), the counterpart of ``ffpic_tpu/models``."""
