from online_neural_cdes_tpu_torch.models.vector_fields import VectorField, VECTOR_FIELDS  # noqa: F401
from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE, SPLINES  # noqa: F401
from online_neural_cdes_tpu_torch.models.stacked import StackedNeuralCDE  # noqa: F401
from online_neural_cdes_tpu_torch.models.attention import AttentionNeuralCDE, sparsemax  # noqa: F401
from online_neural_cdes_tpu_torch.models.odernn import ODERNN  # noqa: F401
from online_neural_cdes_tpu_torch.models.grud import GRUD, prepare_gru_variant_data  # noqa: F401
from online_neural_cdes_tpu_torch.models.rnn import RNN  # noqa: F401
