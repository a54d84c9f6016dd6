from online_neural_cdes_tpu_torch.models.vector_fields import VectorField, VECTOR_FIELDS  # noqa: F401
from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE, SPLINES  # noqa: F401
