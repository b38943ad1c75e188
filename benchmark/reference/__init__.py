"""The plain reference that decides `correct`: FFM and FM logits and
gradients, the loss, FTRL-Proximal on the touched rows, and the eval
pass's log-loss and AUC, written from the published definitions in plain
PyTorch, float32, TF32 off.  It imports nothing of the program under test,
and takes from the benchmark only the generated rows and S0."""
