from elasticsearch_tpu_torch.security.service import (  # noqa: F401
    AuthenticationError, AuthorizationError, SecurityService,
)
