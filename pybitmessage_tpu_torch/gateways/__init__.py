"""Protocol gateways: SMTP in/out (email <-> bitmessage bridging), the
email-gateway account flows and the Namecoin lookup (copy of
``pybitmessage_tpu.gateways``)."""

from .smtp_server import SMTPGateway, SMTP_DOMAIN  # noqa: F401
from .smtp_deliver import SMTPDeliverer  # noqa: F401
