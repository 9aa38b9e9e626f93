"""LM step builders (``steps``) and the greedy-decode driver (``serve``)."""
