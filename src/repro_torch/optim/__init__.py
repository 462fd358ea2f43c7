"""Optimizers of the port's training step (``optim/opt.py``).  The
reference's ``optim/compress.py`` (gradient compression for
``compressed_psum`` under ``shard_map``) belongs to sharding, ROADMAP
item 14f, and is not ported."""
