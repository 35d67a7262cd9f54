from sparse_matrix_tuning_tpu_torch.data.sft import (  # noqa: F401
    SFTDataset,
    make_supervised_data,
    batch_iterator,
    IGNORE_INDEX,
)
from sparse_matrix_tuning_tpu_torch.data.prompts import generate_prompt  # noqa: F401
