"""Host lattices: pruning (``prune``), post-processing (``post``) and link
recall against the oracle (``recall``)."""
