"""Registration: the classical backend (mutual nearest neighbours, RANSAC
and ICP on the device), the evaluator and its metrics."""
