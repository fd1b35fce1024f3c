// Error routes (reference pages/403.jsx, 404.jsx, 500.jsx): shown by the
// router for unknown hashes (404) and by the API client when the server
// answers 403 (e.g. a non-admin opening #/admin).
import { esc, t } from "../app.js";

function errorPage(app, code, message) {
  app.innerHTML = `
    <div class="panel error-page">
      <h1>${esc(code)}</h1>
      <p class="muted">${esc(message)}</p>
      <p><a href="#/jobs">${esc(t("errors.backHome"))}</a></p>
    </div>`;
}

export async function view403(app) {
  errorPage(app, "403", t("errors.forbidden"));
}

export async function view404(app) {
  errorPage(app, "404", t("errors.notFound"));
}

export async function view500(app) {
  errorPage(app, "500", t("errors.serverError"));
}
