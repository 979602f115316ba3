"""The paper's own experimental model: the 4-layer CNN binary classifier
for the CelebA smiling task (LEAF benchmark, GroupNorm, dropout 0.1).

Counterpart of ``repro/configs/celeba_cnn.py``. It is not a decoder
``ModelConfig``: the model lives in ``models.cnn`` and this module carries
the experiment constants of the paper's Appendix D.
"""

IMAGE_SIZE = 32
IN_CHANNELS = 3
N_CLASSES = 2
DROPOUT = 0.1

# Appendix D hyperparameters (inherited from FedBuff)
CLIENT_LR = 4.7e-6
SERVER_LR = 1000.0
SERVER_MOMENTUM = 0.3
BUFFER_K = 10
LEAF_SEED = 1549775860

CONFIG = None  # not a decoder config, as in the reference
REDUCED = None
