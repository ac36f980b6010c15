"""Codecs of the port: the registry, ``Pic`` and each format's copy of
``ffpic_tpu``'s host code."""
