from code_intelligence_tpu_torch.models.awd_lstm import (
    AWDLSTMConfig,
    AWDLSTMEncoder,
    init_lstm_states,
    random_encoder_arrays,
)

__all__ = ["AWDLSTMConfig", "AWDLSTMEncoder", "init_lstm_states",
           "random_encoder_arrays"]
