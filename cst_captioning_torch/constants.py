"""Framework-wide token-id convention: 0=PAD, 1=BOS, 2=EOS, 3=UNK, real
words from 4.  PAD and EOS both terminate a sequence when sampled; the end
token slot is included in loss masks, padding after it is not.

Lives in its own dependency-free module so the host-only data layer and the
model layer can share it without importing each other.
"""

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
NUM_SPECIAL_TOKENS = 4
