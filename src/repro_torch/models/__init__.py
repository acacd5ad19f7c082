"""The LM stack of the port: the ``ssm`` family (Mamba-2) so far."""
