"""The LM stack of the port: the ``ssm``, ``dense``, ``vlm`` and ``hybrid``
families so far (``moe`` and ``encdec`` are still to be ported)."""
