"""Models behind the batched decode, the counterpart of
``ffpic_tpu/models``: the ViT of BASELINE config 5 (``models.vit``,
serving and training) and the mixture-of-experts block
(``models.moe``)."""
