"""piet-tpu test suite (a package, so ``tests.*`` resolves to this
directory before any installed package of the same name)."""
