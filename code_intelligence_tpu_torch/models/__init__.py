from code_intelligence_tpu_torch.models.awd_lstm import (
    AWDLSTMConfig,
    AWDLSTMEncoder,
    AWDLSTMLM,
    draw_dropout_masks,
    init_lstm_states,
    random_encoder_arrays,
)

__all__ = ["AWDLSTMConfig", "AWDLSTMEncoder", "AWDLSTMLM",
           "draw_dropout_masks", "init_lstm_states", "random_encoder_arrays"]
