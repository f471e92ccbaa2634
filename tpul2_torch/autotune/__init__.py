from tpul2_torch.autotune.db import TuneDB, default_db, reset_default_db  # noqa: F401
from tpul2_torch.autotune.search import tune_many, tune_shape  # noqa: F401
