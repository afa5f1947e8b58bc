"""Registration: the classical backend (mutual nearest neighbours, RANSAC
and ICP on the device), the learned coarse-to-fine backend (``learned``,
``geo_model``, ``learned_batch``) and its held-out evaluation
(``eval_geo``), the evaluator and its metrics."""
